"""The port's examples and profile tool on the CPU.

* ``examples/torch_quickstart.py`` and
  ``examples/torch_partitioned_training.py`` run to their end with
  ``--device cpu``; without a card the default ``--device cuda`` raises.
* ``examples/torch_traffic_shaping_demo.py`` prints what
  ``examples/traffic_shaping_demo.py`` prints, byte for byte, without a
  card: both are numpy over host modules the port holds exactly equal
  (``tests/test_torch_shaping.py``).
* ``tools/torch_make_reference_profile.py``: given the reference tool's
  peak (read here only), ``build_reference_model`` reproduces the
  committed ``docs/profiles/qwen2_7b_smoke.json`` and its int8 variant
  byte for byte, as ``tests/test_cost_model.py`` pins the reference's
  tool; its CLI prices at one H100 and writes a profile that replays.
"""
import contextlib
import importlib.util
import io
from pathlib import Path

import pytest
import torch

from repro.core import hw as jhw
from repro_torch.configs import get_config
from repro_torch.core import hw
from repro_torch.profiling import load_profile, save_profile

ROOT = Path(__file__).resolve().parents[1]


def _load(rel):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_cpu(tmp_path, capsys):
    out = _load("examples/torch_quickstart.py").main(
        ["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert len(out) == 8 and "generated:" in text
    assert (tmp_path / "step_20").is_dir()
    first, last = (float(line.split("loss=")[1].split()[0])
                   for line in text.splitlines()
                   if line.startswith("step") and line.split()[1] in
                   ("0", "15"))
    assert last < first


def test_partitioned_training_cpu(capsys):
    losses = _load("examples/torch_partitioned_training.py").main(
        ["--device", "cpu"])
    text = capsys.readouterr().out
    assert len(losses) == 16
    assert sorted(losses[8]) == [0, 1, 2, 3]
    assert sorted(losses[9]) == [0, 1, 3]          # partition 2 failed
    assert "alive=3/4" in text and "weight-replica bytes=" in text


@pytest.mark.parametrize("rel", ["examples/torch_quickstart.py",
                                 "examples/torch_partitioned_training.py"])
def test_examples_need_a_card_by_default(rel):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        _load(rel).main([])


def test_shaping_demo_prints_the_reference_bytes():
    outs = []
    for rel in ("examples/traffic_shaping_demo.py",
                "examples/torch_traffic_shaping_demo.py"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _load(rel).main()
        outs.append(buf.getvalue().encode())
    assert outs[0] and outs[1] == outs[0]


@pytest.mark.parametrize("kv,name", [("fp32", "qwen2_7b_smoke.json"),
                                     ("int8", "qwen2_7b_smoke_kv_int8.json")])
def test_profile_tool_reproduces_the_committed_profiles(tmp_path, kv, name):
    tool = _load("tools/torch_make_reference_profile.py")
    model = tool.build_reference_model(
        get_config("qwen2-7b", smoke=True), jhw.TPU_PEAK_FLOPS / 4, slots=4,
        prompt_len=32, gen=16, kv_dtype=kv)
    out = save_profile(model, tmp_path / name)
    assert out.read_bytes() == (ROOT / "docs" / "profiles" / name).read_bytes()


def test_profile_tool_cli_prices_at_the_h100(tmp_path):
    tool = _load("tools/torch_make_reference_profile.py")
    out = tmp_path / "p.json"
    tool.main(["--workers", "2", "--out", str(out)])
    cfg = get_config("qwen2-7b", smoke=True)
    loaded = load_profile(out, cfg)
    assert loaded.peak_flops == hw.H100_PEAK_FLOPS / 2
    assert loaded.timer is None and loaded.n_warm == 12
    ana = loaded.analytic
    assert loaded.prefill(4, 32).duration == pytest.approx(
        ana.prefill(4, 32).duration * tool.PREFILL_SKEW)
    assert loaded.decode([40] * 4).duration == pytest.approx(
        ana.decode([40] * 4).duration * tool.DECODE_SKEW)
    with pytest.raises(SystemExit):
        tool.main(["--workers", "0", "--out", str(out)])
