"""The port's measured cost model against the JAX reference's.

``repro_torch.profiling.cost_model`` is the reference's
``repro/profiling/cost_model.py`` with only its import paths and default
pricing rate changed, so on the same config and the same observations the
two price every op to the same floats:

* the frozen replay of each committed profile (the reference's
  ``docs/profiles/qwen2_7b_smoke*.json`` and the port's calibration on the
  card, ``qwen2_7b_h100.json``) prices ``prefill``, ``prefill_ragged`` and
  ``decode`` over a grid of shapes exactly as the reference does
  (durations, bytes and FLOPs);
* ``save_profile`` of one calibration, fed the same observations, writes
  byte-identical JSON, and each side loads the other's file;
* ``make_cost_model``'s cases (analytic, fresh measured, replay, ``blend``
  override, kv repricing, bad names and values) behave the same;
* the serve CLI calibrates live with ``--cost-model measured --profile``,
  writes the profile, and a second run replays it frozen.
"""
from pathlib import Path

import numpy as np
import pytest

from repro import profiling as J
from repro.configs import get_config as jget_config
from repro_torch import profiling as T
from repro_torch.configs import get_config
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
# the reference's committed profiles, then the port's calibration on an H100
PROFILES = ("qwen2_7b_smoke.json", "qwen2_7b_smoke_kv_int8.json",
            "qwen2_7b_h100.json")
PEAK = 1e12
BATCHES = (1, 2, 3, 4)
PROMPTS = (1, 8, 17, 31, 32, 33, 64, 999)
RAGGED = ([32], [32, 20, 27, 9], [8, 8], [5, 64, 33], [1, 2, 3, 4])
CTXS = ([40], [33, 35], [32, 40, 48, 56], [1, 2, 3, 4], [300] * 4, [64, 9])


def _cfgs():
    return jget_config("qwen2-7b", smoke=True), get_config("qwen2-7b",
                                                           smoke=True)


def _fields(c):
    return (c.flops, c.byts, c.duration)


def _price_grid(model):
    out = []
    for b in BATCHES:
        for p in PROMPTS:
            for cached in (0, 4):
                out.append(_fields(model.prefill(b, p, cached)))
    for lens in RAGGED:
        out.append(_fields(model.prefill_ragged(lens)))
        out.append(_fields(model.prefill_ragged(lens, [min(l, 4)
                                                       for l in lens])))
    for ctxs in CTXS:
        out.append(_fields(model.decode(ctxs)))
    return out


@pytest.mark.parametrize("name", PROFILES)
def test_frozen_replay_prices_exactly_as_reference(name):
    jcfg, tcfg = _cfgs()
    path = ROOT / "docs" / "profiles" / name
    jm, tm = J.load_profile(path, jcfg), T.load_profile(path, tcfg)
    assert jm.timer is None and tm.timer is None
    assert tm.n_warm == jm.n_warm > 0
    assert (tm.blend, tm.kv_dtype, tm.sparse_keep, tm.peak_flops) == \
        (jm.blend, jm.kv_dtype, jm.sparse_keep, jm.peak_flops)
    grid = _price_grid(tm)
    assert grid == _price_grid(jm)
    # the grid reaches warm buckets (measured) and cold ones (analytic)
    ana = [_fields(tm.analytic.decode(c)) for c in CTXS]
    assert any(g != a for g, a in zip(grid[-len(CTXS):], ana))
    assert any(g == a for g, a in zip(grid[-len(CTXS):], ana))


def _calibrate(pkg, cfg, **kw):
    model = pkg.MeasuredCostModel(cfg, PEAK, timer=pkg.PhaseTimer(), **kw)
    rng = np.random.default_rng(3)
    for _ in range(40):
        b = int(rng.integers(1, 5))
        model.observe("decode", b, int(rng.integers(8, 400)),
                      float(rng.uniform(1e-4, 3e-2)))
        model.observe("prefill", b, int(rng.integers(1, 80)),
                      float(rng.uniform(1e-3, 9e-2)))
    return model


@pytest.mark.parametrize("kw", [{}, dict(blend=0.5),
                                dict(kv_dtype="int8", sparse_keep=0.75)])
def test_save_profile_writes_the_reference_bytes(tmp_path, kw):
    jcfg, tcfg = _cfgs()
    jm, tm = _calibrate(J, jcfg, **kw), _calibrate(T, tcfg, **kw)
    jp = J.save_profile(jm, tmp_path / "jax" / "p.json")
    tp = T.save_profile(tm, tmp_path / "torch" / "p.json")
    assert tp.read_bytes() == jp.read_bytes()
    assert _price_grid(tm) == _price_grid(jm)
    # each side replays the other's file to the same prices
    assert _price_grid(T.load_profile(jp, tcfg)) == \
        _price_grid(J.load_profile(tp, jcfg))


def _describe(model):
    return (model.kind, getattr(model, "timer", None) is None,
            getattr(model, "blend", None), model.dtype_bytes,
            getattr(model, "kv_dtype", None),
            getattr(model, "sparse_keep", None), _price_grid(model))


@pytest.mark.parametrize("case", [
    dict(name="analytic"),
    dict(name="analytic", kv_dtype="fp8", sparse_keep=0.5),
    dict(name="measured"),
    dict(name="measured", blend=0.25),
    dict(name="measured", profile="missing.json"),
    dict(name="measured", profile=PROFILES[0]),
    dict(name="measured", profile=PROFILES[0], blend=0.5),
    dict(name="measured", profile=PROFILES[0], kv_dtype="int8"),
    dict(name="measured", profile=PROFILES[1], sparse_keep=0.8),
])
def test_make_cost_model_cases_match_reference(tmp_path, case):
    jcfg, tcfg = _cfgs()
    kw = dict(case)
    name = kw.pop("name")
    if "profile" in kw:
        p = ROOT / "docs" / "profiles" / kw["profile"]
        kw["profile"] = p if p.exists() else tmp_path / kw["profile"]
    jm = J.make_cost_model(name, jcfg, PEAK, **kw)
    tm = T.make_cost_model(name, tcfg, PEAK, **kw)
    assert _describe(tm) == _describe(jm)


@pytest.mark.parametrize("name,kw,match", [
    ("psychic", {}, "cost model must be"),
    ("measured", dict(blend=2.0), "blend"),
    ("measured", dict(profile=ROOT / "docs" / "profiles" / PROFILES[0],
                      blend=-0.5), "blend"),
    ("analytic", dict(kv_dtype="int4"), "kv_dtype"),
    ("measured", dict(sparse_keep=0.0), "sparse_keep"),
])
def test_make_cost_model_refuses_like_reference(name, kw, match):
    jcfg, tcfg = _cfgs()
    with pytest.raises(ValueError, match=match) as je:
        J.make_cost_model(name, jcfg, PEAK, **kw)
    with pytest.raises(ValueError, match=match) as te:
        T.make_cost_model(name, tcfg, PEAK, **kw)
    assert str(te.value) == str(je.value)


def test_load_profile_refuses_another_arch_like_reference(tmp_path):
    jcfg, tcfg = _cfgs()
    path = T.save_profile(_calibrate(T, tcfg), tmp_path / "p.json")
    with pytest.raises(ValueError, match="calibrated for") as je:
        J.load_profile(path, jcfg.replace(name="other"))
    with pytest.raises(ValueError, match="calibrated for") as te:
        T.load_profile(path, tcfg.replace(name="other"))
    assert str(te.value) == str(je.value)


def test_default_peak_is_the_h100_data_sheet():
    from repro_torch.core import hw

    _, tcfg = _cfgs()
    assert T.MeasuredCostModel(tcfg).peak_flops == hw.H100_PEAK_FLOPS
    assert T.make_cost_model("measured", tcfg).peak_flops == \
        hw.H100_PEAK_FLOPS


def test_serve_cli_calibrates_then_replays(tmp_path, capsys):
    path = tmp_path / "prof" / "qwen2_7b_cpu.json"
    argv = ["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
            "--partitions", "2", "--stagger", "demand", "--requests", "6",
            "--batch", "2", "--prompt-len", "8", "--gen", "6", "--no-sim",
            "--cost-model", "measured", "--profile", str(path)]
    first = serve.main(argv)
    out = capsys.readouterr().out
    assert "measured (calibrating)" in out and path.exists()
    _, tcfg = _cfgs()
    saved = T.load_profile(path, tcfg)
    assert saved.n_observations > 0
    again = serve.main(argv)
    out = capsys.readouterr().out
    assert "measured (replay)" in out and "written" not in out
    assert sum(len(s) for s in again) == sum(len(s) for s in first) == 6 * 6
    # the reference loads the port's profile to the same prices
    jcfg, _ = _cfgs()
    assert _price_grid(J.load_profile(path, jcfg)) == _price_grid(saved)
