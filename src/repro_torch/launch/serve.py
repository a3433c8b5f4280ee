"""Serving CLI of the port: P partition engines in torch on one device.

The in-process fleet path of ``repro/launch/serve.py`` with the same
flags: P partition engines (the paper's compute-unit partitions, applied
to one serving device) run phase-staggered continuous batching under the
traffic-shaping scheduler; each partition gets 1/P of the compute while
all share one HBM pipe.  The virtual clock prices every op at the H100's
data-sheet rates; on the card the model runs through the port's CUDA
kernels.  Prints throughput, latency percentiles, the bandwidth-demand std
and the fluid-simulation validation of the shaping claim.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --partitions 2 --stagger demand                 # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --smoke --device cpu                            # plain PyTorch path

``--device`` (default ``cuda``) never falls back: without a card, ask for
the CPU.  The bandwidth levers run on both: ``--kv-dtype int8/fp8``
(packed KV pages), ``--sparse-threshold T`` (blockwise-sparse decode) and
``--prefix-cache``, in any mix, and ``--dense`` serves from the dense KV
slab instead of the paged pool (whisper-base always does, as in the
reference: ``--arch whisper-base`` serves the enc-dec family wave by wave,
each wave's frame embeddings drawn from the engine's seed).  Every engine
runs its decode steps as
replays of one captured CUDA graph on the card
(``serving/step_graph.py``), and its prefill waves and slot refills as
replays of one graph per shape from a cache the fleet shares
(``serving/prefill_graph.py``); each engine's decode counts and the
fleet's prefill counts are printed at the end.

``--cost-model measured`` prices the demand-shaping rule from wall-clocked
phase ops instead of the analytic decomposition; with ``--profile PATH``
the run loads an existing calibration profile (frozen deterministic
replay) or, when the file does not exist yet, calibrates live and writes
it at exit, as the reference does.

``--trace PATH`` writes a Chrome-trace / Perfetto JSON of the run (host
events on the virtual clock, as the reference records them;
``tools/torch_trace_export.py --check PATH`` validates it).  ``--cluster
N`` runs the same load as a controller + N partition-worker cluster
instead (one OS process per worker under ``--transport mp``, worker w on
card w % count; see ``repro_torch.launch.cluster`` for the routing,
PD and failover flags).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import hw
from repro_torch.device import resolve
from repro_torch.launch.cluster import (build_cluster_args, run_cluster,
                                        validate_cluster_args)
from repro_torch.models import api as mapi
from repro_torch.obs import (Tracer, format_summary, observe_phase_durations,
                             registry_from_engines, write_chrome)
from repro_torch.profiling import make_cost_model, save_profile
from repro_torch.profiling.cost_model import KV_PRICE_BYTES
from repro_torch.serving import (CLOCKS, EventScheduler, PartitionEngine,
                                 RequestQueue, decode_cost, make_scheduler,
                                 prefill_cost, serving_trace_report)
from repro_torch.serving.prefill_graph import PrefillGraphs
from repro_torch.serving.trace_sim import phase_balanced_bandwidth


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="serve an LM with P phase-staggered partition engines "
                    "(PyTorch / CUDA port)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (with --cluster: worker w "
                         "on card w %% count); 'cuda' (the default) raises "
                         "when there is no card")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots per partition")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--partitions", type=int, default=None)
    ap.add_argument("--stagger", default=None,
                    choices=["none", "uniform", "demand"])
    ap.add_argument("--clock", default=None, choices=list(CLOCKS),
                    help="virtual clock: 'event' overlaps partition ops on "
                         "the contention timeline (the default), "
                         "'lockstep' advances the fleet tick by tick (the "
                         "regression oracle)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV pool block size (tokens)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission control: max queued requests")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request completion deadline (virtual s)")
    ap.add_argument("--no-sim", action="store_true",
                    help="skip the serving-trace shaping validation")
    ap.add_argument("--dense", action="store_true",
                    help="dense per-wave KV slab instead of the paged pool "
                         "(the equivalence oracle)")
    ap.add_argument("--cluster", type=int, default=None, metavar="N",
                    help="run as a controller + N partition-worker cluster "
                         "instead of the in-process fleet (see "
                         "repro_torch.launch.cluster; --router/--transport "
                         "pick the routing policy and worker transport)")
    ap.add_argument("--simulated", action="store_true",
                    help="with --cluster: SimulatedEngine workers")
    # the cluster axis, the cost model, the bandwidth levers and --trace
    build_cluster_args(ap)
    return ap


def main(argv=None, engines_out=None):
    """Serve the load ``argv`` describes; returns each slot's token stream.
    A list passed as ``engines_out`` gets the fleet's engines appended, so
    a caller can read their counters after the run."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.partitions is not None and args.partitions < 1:
        ap.error(f"--partitions must be >= 1 (got {args.partitions}): the "
                 "fleet needs at least one partition engine")
    if args.batch < 1:
        ap.error(f"--batch must be >= 1 (got {args.batch}): each partition "
                 "needs at least one decode slot")
    if args.requests < 1:
        ap.error(f"--requests must be >= 1 (got {args.requests})")
    if args.cluster is not None and args.cluster < 1:
        ap.error(f"--cluster must be >= 1 (got {args.cluster})")
    validate_cluster_args(ap, args)
    if args.trace is not None and args.clock == "lockstep":
        ap.error("--trace records the event-driven contention clock; the "
                 "lockstep oracle has no span timeline to trace")
    if args.cluster is None and args.router == "pd":
        ap.error("--router pd needs --cluster N: prefill/decode "
                 "disaggregation routes between cluster workers")
    if args.pd_split is not None and args.cluster is not None \
            and sum(args.pd_split) != args.cluster:
        ap.error(f"--pd-split {args.pd_split[0]}:{args.pd_split[1]} does "
                 f"not cover the {args.cluster}-worker fleet")

    device = resolve(args.device)
    if args.cluster is not None:
        # controller + N worker-process cluster (repro_torch.launch.
        # cluster).  The in-process-only axes have no cluster meaning:
        # reject them loudly rather than run a configuration the user did
        # not ask for.
        for flag, val, hint in [
                ("--partitions", args.partitions, "--cluster N IS the "
                 "partition count"),
                ("--stagger", args.stagger, "use --router (round_robin ~ "
                 "none, shaping ~ demand)"),
                ("--clock", args.clock, "the cluster always runs the "
                 "event-driven contention clock")]:
            if val is not None:
                ap.error(f"{flag} applies to the in-process fleet and is "
                         f"ignored by --cluster; {hint}")
        ctl, _ = run_cluster(
            arch=args.arch, smoke=args.smoke, workers=args.cluster,
            slots=args.batch, prompt_len=args.prompt_len, gen=args.gen,
            n_requests=args.requests, router=args.router,
            transport=args.transport, simulated=args.simulated,
            block_size=args.block_size, dense=args.dense,
            heartbeat_timeout=args.heartbeat_timeout,
            max_queue=args.max_queue, deadline=args.deadline,
            cost_model=args.cost_model, profile=args.profile,
            pd_split=args.pd_split, prefix_cache=args.prefix_cache,
            kv_dtype=args.kv_dtype, sparse_threshold=args.sparse_threshold,
            trace=args.trace, device=str(device))
        return [r.tokens for r in ctl.queue.completed]

    cfg = get_config(args.arch, smoke=args.smoke)
    P = args.partitions if args.partitions is not None else 1
    args.stagger = args.stagger if args.stagger is not None else "uniform"
    args.clock = args.clock if args.clock is not None else "event"
    slots = args.batch
    peak_per_part = hw.H100_PEAK_FLOPS / P  # partitions split one device

    # --- phase pricing: one cost model shared by the whole fleet (same
    # shapes, same device -> shared EMA buckets warm P times faster).
    # measured + existing profile = frozen deterministic replay; measured
    # without one = live calibration (saved to --profile at exit, if set).
    cost_model = None  # None -> engines default to AnalyticCostModel
    if args.cost_model == "measured":
        cost_model = make_cost_model(
            "measured", cfg, peak_per_part, profile=args.profile,
            kv_dtype=args.kv_dtype,
            sparse_keep=1.0 - args.sparse_threshold)
    max_len = args.prompt_len + 4 * args.gen + (cfg.n_meta_tokens or 0) + \
        (cfg.n_img_tokens or 0)

    # --- engines: in-process the (read-only) params are aliased; real
    # deployments replicate per partition (the reuse-vs-shaping tradeoff).
    # Built BEFORE the request load so admission control can probe the
    # fleet's prefix caches (a hit-eligible request is priced post-hit).
    # One cache of prefill graphs for the fleet: each shape is captured
    # once, not once per partition.
    api = mapi.build(cfg, device)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    prefill_graphs = PrefillGraphs(api)
    # enc-dec serves from the dense slab, as in the reference
    paged = (cfg.family != "encdec") and not args.dense
    engines = [PartitionEngine(cfg, api, params, slots=slots,
                               max_len=max_len, pid=p,
                               peak_flops=peak_per_part,
                               paged=paged,
                               block_size=args.block_size,
                               cost_model=cost_model,
                               prefix_cache=args.prefix_cache,
                               kv_dtype=args.kv_dtype,
                               sparse_threshold=args.sparse_threshold,
                               prefill_graphs=prefill_graphs)
               for p in range(P)]
    if engines_out is not None:
        engines_out.extend(engines)

    # --- request load + admission control ---
    kv_price = KV_PRICE_BYTES.get(args.kv_dtype)
    kv_keep = 1.0 - args.sparse_threshold

    def estimate(req):
        pre = prefill_cost(cfg, slots, req.prompt_len, peak_per_part,
                           cached=req.cached_len, kv_dtype_bytes=kv_price)
        dec = decode_cost(cfg, slots, req.prompt_len + args.gen // 2,
                          peak_per_part, kv_dtype_bytes=kv_price,
                          kv_keep=kv_keep)
        return pre.duration + req.max_new_tokens * dec.duration

    # the probe answers "how much of this prompt is already resident
    # SOMEWHERE in the fleet" — optimistic across engines (the scheduler
    # is free to seat the request on the engine that holds the prefix)
    probe = (lambda req: max(e.peek_cached(req) for e in engines)) \
        if args.prefix_cache else None
    queue = RequestQueue(max_depth=args.max_queue, service_estimate=estimate,
                         prefix_probe=probe)
    # the tracer must watch the queue BEFORE the load goes in, so the
    # admission instants and lifecycle 'submit' records are captured
    tracer = None
    if args.trace is not None:
        tracer = Tracer()
        queue.tracer = tracer
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        queue.submit(rng.integers(1, cfg.vocab, size=(args.prompt_len,))
                     .astype(np.int32), args.gen, arrival=0.0,
                     deadline=args.deadline)

    # pipe sized inside the load's phase dynamic range (see trace_sim)
    bandwidth = phase_balanced_bandwidth(
        cfg, total_slots=P * slots, prompt_len=args.prompt_len, gen=args.gen)
    sched = make_scheduler(engines, queue, policy=args.stagger,
                           bandwidth=bandwidth, clock=args.clock)
    if tracer is not None:
        sched.attach_tracer(tracer)
    m = sched.run()
    s = m.summary()
    print(f"serve: {cfg.name} device={device} P={P} stagger={args.stagger} "
          f"clock={args.clock} cost_model={args.cost_model} "
          f"kv={args.kv_dtype} sparse={args.sparse_threshold:g} "
          f"dense={args.dense} slots={P}x{slots} "
          f"completed={s['requests_completed']}/{queue.n_submitted} "
          f"rejected={queue.n_rejected}")
    for eng in engines:
        g = eng.graph
        if g is not None:
            print(f"  decode graph p{eng.pid}: {g.n_eager} eager steps, "
                  f"{g.n_replays} replays, capture {g.capture_s:.3f} s")
    pg = prefill_graphs
    print(f"  prefill graphs: {len(pg.uses)} shapes, {pg.n_eager} eager "
          f"runs, {pg.n_captures} captures, {pg.n_replays} replays, "
          f"{pg.n_evictions} evictions, capture {pg.capture_s:.3f} s")
    if cost_model is not None:
        mode = "replay" if cost_model.timer is None else "calibrating"
        print(f"  cost model: measured ({mode}) "
              f"warm_buckets={cost_model.n_warm} "
              f"observations={cost_model.n_observations}")
        if cost_model.timer is not None and args.profile is not None:
            out = save_profile(cost_model, args.profile)
            print(f"  cost model: calibration profile written to {out}")
    reg = registry_from_engines(engines, queue=queue)
    observe_phase_durations(reg, getattr(sched, "trace", ()))
    achieved = sched.achieved_bw_stats() \
        if isinstance(sched, EventScheduler) else None
    lifecycle = tracer.lifecycle.format_exit_line() \
        if tracer is not None else None
    for line in format_summary(s, reg, bandwidth=bandwidth,
                               achieved=achieved,
                               prefix_cache=args.prefix_cache,
                               lifecycle=lifecycle):
        print(line)
    if tracer is not None:
        doc = write_chrome(tracer, args.trace)
        print(f"  trace: {len(doc['traceEvents'])} events -> {args.trace}")

    if not args.no_sim:
        rep = serving_trace_report(
            cfg, partitions=P, policy=args.stagger, total_slots=P * slots,
            n_requests=max(args.requests, P), prompt_len=args.prompt_len,
            gen=args.gen, bandwidth=bandwidth)
        print(f"  sim: P={P} {args.stagger} bw_std={rep['bw_std']/1e9:.2f} "
              f"GB/s vs P=1 sync {rep['base_bw_std']/1e9:.2f} GB/s "
              f"(x{rep['std_rel']:.2f}, bw_mean x{rep['mean_rel']:.2f}, "
              f"perf x{rep['perf_rel']:.2f})")

    # per-slot token streams across all partitions (the return contract)
    return [toks for eng in engines for toks in eng.slot_tokens]


if __name__ == "__main__":
    main()
