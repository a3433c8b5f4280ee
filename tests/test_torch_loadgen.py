"""The port's open-loop load generator (``repro_torch.serving.loadgen``)
against the reference's.

Every arrival process, length mix and trace is seeded numpy on the host:
the port's copy must give the reference's arrays and ``OfferedRequest``
traces exactly, for several seeds and shapes; goodput arithmetic must
agree; and an open-loop trace injected into a loopback cluster of each
package on the virtual clock must complete with the same stamps.
"""
import numpy as np
import pytest

from repro.serving import loadgen as J
from repro.serving import RequestQueue as JQueue
from repro.serving import make_cluster as jmake_cluster
from repro.serving import make_worker_specs as jmake_specs
from repro_torch.serving import loadgen as T
from repro_torch import serving as tserving
from repro_torch.serving import RequestQueue as TQueue
from repro_torch.serving import make_cluster as tmake_cluster
from repro_torch.serving import make_worker_specs as tmake_specs

SEEDS = (0, 1, 7, 1234)
PEAK, BW = 1e12, 2e11


def test_exports_match_reference():
    assert T.ARRIVALS == J.ARRIVALS
    for name in ("ARRIVALS", "LengthMix", "OfferedRequest", "SloSpec",
                 "goodput_stats", "make_arrivals", "make_trace",
                 "schedule_arrivals", "submit_trace"):
        assert getattr(tserving, name) is getattr(T, name)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", J.ARRIVALS)
def test_arrivals_equal_reference(kind, seed):
    for rate, horizon in ((500.0, 2.0), (3e6, 5e-6)):
        a = T.make_arrivals(kind, rate, horizon, seed=seed)
        b = J.make_arrivals(kind, rate, horizon, seed=seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert len(a) and np.all(np.diff(a) >= 0) and a[-1] < horizon


@pytest.mark.parametrize("seed", SEEDS)
def test_arrival_options_and_helpers_equal_reference(seed):
    assert np.array_equal(
        T.diurnal_arrivals(800.0, 3.0, seed, period=1.5, peak_ratio=6.0),
        J.diurnal_arrivals(800.0, 3.0, seed, period=1.5, peak_ratio=6.0))
    assert np.array_equal(
        T.bursty_arrivals(800.0, 3.0, seed, burst_ratio=5.0, duty=0.4,
                          period=0.5),
        J.bursty_arrivals(800.0, 3.0, seed, burst_ratio=5.0, duty=0.4,
                          period=0.5))
    assert np.array_equal(T.poisson_arrivals(50.0, 4.0, seed),
                          J.poisson_arrivals(50.0, 4.0, seed))
    assert T.bursty_rates(100.0, 8.0, 0.25) == J.bursty_rates(100.0, 8.0,
                                                              0.25)
    kw = dict(median=48.0, alpha=1.3, lo=2, hi=400)
    a = T.heavy_tail_lengths(257, seed, **kw)
    b = J.heavy_tail_lengths(257, seed, **kw)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    tm, jm = T.LengthMix(prompt_median=20), J.LengthMix(prompt_median=20)
    assert np.array_equal(tm.prompt_lengths(64, seed),
                          jm.prompt_lengths(64, seed))
    assert np.array_equal(tm.gen_lengths(64, seed), jm.gen_lengths(64, seed))


def test_bad_arguments_raise_as_the_reference():
    for mod in (T, J):
        with pytest.raises(ValueError, match="arrival kind"):
            mod.make_arrivals("tsunami", 1.0, 1.0)
        with pytest.raises(ValueError, match="duty"):
            mod.bursty_rates(1.0, 2.0, duty=1.0)
        with pytest.raises(ValueError, match="burst_ratio"):
            mod.bursty_rates(1.0, 0.5, duty=0.25)


def _trace(mod, kind, seed, slo=True):
    return mod.make_trace(
        kind, 4e6, 4e-6, seed=seed,
        slo=mod.SloSpec(ttft_budget=1e-6, tpot_budget=2e-7) if slo else None,
        mix=mod.LengthMix(prompt_median=8, prompt_max=16, gen_median=4,
                          gen_max=8),
        max_len=32, arrival_kw={"period": 1e-6} if kind != "poisson" else {},
        vocab=256)


def _fields(trace):
    return [(r.arrival, r.max_new_tokens, r.deadline, r.prompt.dtype.str,
             tuple(int(t) for t in r.prompt)) for r in trace]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", J.ARRIVALS)
def test_traces_equal_reference(kind, seed):
    for slo in (True, False):
        a, b = _trace(T, kind, seed, slo), _trace(J, kind, seed, slo)
        assert len(a) == len(b) > 0
        assert _fields(a) == _fields(b)


def test_goodput_stats_equal_reference():
    class _Q:
        n_submitted, n_rejected = 6, 2

        class _R:
            def __init__(self, t_done, deadline):
                self.t_done, self.deadline = t_done, deadline

        completed = [_R(1.0, 2.0), _R(3.0, 2.0), _R(1.0, None),
                     _R(2.0, 2.0)]

    assert T.goodput_stats(_Q()) == J.goodput_stats(_Q())
    assert T.goodput_stats(_Q())["goodput"] == pytest.approx(3.0 / 8.0)


@pytest.mark.parametrize("kind", J.ARRIVALS)
def test_open_loop_cluster_equals_reference(kind):
    """``schedule_arrivals`` drives a loopback cluster
    of each package through the same trace: identical stamps, goodput and
    final clock."""
    out = {}
    for name, mod, Q, make, specs in (
            ("jax", J, JQueue, jmake_cluster, jmake_specs),
            ("torch", T, TQueue, tmake_cluster, tmake_specs)):
        trace = _trace(mod, kind, seed=2)
        q = Q()
        ctl = make(specs("qwen2-7b", 2, max_len=64, peak_flops_total=PEAK),
                   q, transport="loopback", router="round_robin",
                   bandwidth=BW)
        n = mod.schedule_arrivals(ctl.timeline, q, trace,
                                  on_arrival=ctl.pump)
        assert n == len(trace)
        ctl.run()
        out[name] = (sorted((r.rid, r.t_first_token, r.t_done)
                            for r in q.completed),
                     mod.goodput_stats(q), ctl.timeline.now)
        assert len(q.completed) == len(trace) > 4
    assert out["torch"] == out["jax"]


def test_submit_trace_equals_reference():
    counts = []
    for mod, Q in ((J, JQueue), (T, TQueue)):
        q = Q(max_depth=5)
        n = mod.submit_trace(q, _trace(mod, "bursty", seed=3))
        counts.append((n, q.n_submitted, q.n_rejected,
                       [r.rid for r in q._fifo]))
    assert counts[0] == counts[1]
