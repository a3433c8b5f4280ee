"""The port's training loss against the JAX reference for the SSM
(mamba2-130m), hybrid (hymba-1.5b: meta tokens, the 32-key window,
attention and SSM side by side) and enc-dec (whisper-base's
``loss_encdec``) families at the smoke size, on the reference's weights and
the same ``synth_lm_batch``: the loss and its metrics, the gradient of
every parameter and the forward's logits, in fp32 and bf16 (tolerances in
``_torch_train_common.py``).
"""
import pytest
from _torch_train_common import (TOL, build_case, check_forward,
                                 check_gradients, check_loss)

ARCHS = ["mamba2-130m", "hymba-1.5b", "whisper-base"]


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    return build_case(*request.param)


def test_loss_and_metrics(case):
    check_loss(case)


def test_every_gradient(case):
    check_gradients(case)


def test_forward_logits(case):
    check_forward(case)
