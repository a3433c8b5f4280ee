"""The port's paper-reproduction simulator against the JAX package.

``repro_torch.core.shaping_sim`` (``tasks_from_traces``, ``simulate``,
``partition_sweep``) and ``repro_torch.core.schedule`` (``demand_profile``,
``optimize_offsets``, ``aggregate_profile_std``) are pure numpy copies of
the reference's, priced with the same KNL constants, so on the same layer
traces of VGG-16, GoogLeNet and ResNet-50 their results must be EXACTLY
equal.  Small ``n_passes`` and P in {2, 4} keep the file fast.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import hw as jhw
from repro.core import schedule as jschedule
from repro.core import shaping_sim as jsim
from repro.models import cnn as jcnn
from repro_torch.core import hw, schedule, shaping_sim as sim
from repro_torch.models import cnn

NETS = ("vgg16", "googlenet", "resnet50")


@pytest.fixture(scope="module")
def traces():
    return {n: cnn.model_traces(n) for n in NETS}


def _same_result(a, b):
    np.testing.assert_array_equal(a.time, b.time)
    np.testing.assert_array_equal(a.bw, b.bw)
    assert (a.images, a.elapsed, a.passes, a.steady_rate) == \
        (b.images, b.elapsed, b.passes, b.steady_rate)
    assert (a.throughput, a.bw_mean, a.bw_std) == \
        (b.throughput, b.bw_mean, b.bw_std)


def test_knl_constants_equal_reference():
    for k in ("KNL_CORES", "KNL_PEAK_FLOPS", "KNL_FLOPS_PER_CORE",
              "KNL_MEM_BW", "KNL_MEM_GB", "KNL_LLC_BYTES"):
        assert getattr(hw, k) == getattr(jhw, k), k
    assert sim.ACT_AMP == jsim.ACT_AMP and sim.KIND_EFF == jsim.KIND_EFF


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("batch,cores", [(64, 64), (16, 16)])
def test_tasks_from_traces_equal_reference(traces, name, batch, cores):
    ours = sim.tasks_from_traces(traces[name], batch, cores)
    ref = jsim.tasks_from_traces(jcnn.model_traces(name), batch, cores)
    assert [dataclasses.astuple(t) for t in ours] == \
        [dataclasses.astuple(t) for t in ref]


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("P,stagger", [(1, "none"), (2, "none"),
                                       (4, "uniform"), (4, "random")])
def test_simulate_equals_reference(traces, name, P, stagger):
    kw = dict(partitions=P, total_batch=64, n_passes=3, stagger=stagger,
              seed=5)
    _same_result(sim.simulate(traces[name], **kw),
                 jsim.simulate(jcnn.model_traces(name), **kw))


@pytest.mark.parametrize("name", NETS)
def test_partition_sweep_equals_reference(traces, name):
    ours = sim.partition_sweep(traces[name], [2, 4], n_passes=3)
    ref = jsim.partition_sweep(jcnn.model_traces(name), [2, 4], n_passes=3)
    assert ours == ref
    assert set(ours) == {1, 2, 4} and ours[1]["perf"] == 1.0


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("P", [2, 4])
def test_optimize_offsets_equal_reference(traces, name, P):
    b, c = 64 // P, 64 // P
    off = schedule.optimize_offsets(traces[name], P, b, c, n_bins=512)
    joff = jschedule.optimize_offsets(jcnn.model_traces(name), P, b, c,
                                      n_bins=512)
    np.testing.assert_array_equal(off, joff)
    assert off[0] == 0.0 and off.shape == (P,)
    assert schedule.aggregate_profile_std(traces[name], off, b, c,
                                          n_bins=512) == \
        jschedule.aggregate_profile_std(jcnn.model_traces(name), joff, b, c,
                                        n_bins=512)
    prof, t = schedule.demand_profile(traces[name], b, c, n_bins=512)
    jprof, jt = jschedule.demand_profile(jcnn.model_traces(name), b, c,
                                         n_bins=512)
    np.testing.assert_array_equal(prof, jprof)
    assert t == jt


def test_optimized_offsets_through_the_sweep(traces):
    """Custom offsets from the optimizer drive ``simulate`` as in the
    reference, and never raise the analytic aggregate std above uniform."""
    tr = traces["googlenet"]
    off = schedule.optimize_offsets(tr, 4, 16, 16, n_bins=512)
    uni = np.arange(4) / 4
    assert schedule.aggregate_profile_std(tr, off, 16, 16, n_bins=512)[0] \
        <= schedule.aggregate_profile_std(tr, uni, 16, 16, n_bins=512)[0]
    ours = sim.partition_sweep(tr, [4], n_passes=3, offsets_map={4: off})
    ref = jsim.partition_sweep(jcnn.model_traces("googlenet"), [4],
                               n_passes=3, offsets_map={4: off})
    assert ours == ref
