"""Cluster serving CLI of the port: controller + N partition workers.

The reference's ``repro/launch/cluster.py`` with the same flags, plus
``--device``.  A controller process hosts the ``RequestQueue``, the routing
policy and the shared contention clock (priced at the H100's data-sheet
rates); each worker process wraps one ``PartitionEngine`` (its own model
replica — the paper's per-partition weight replication) running through
the port's CUDA kernels, or a ``SimulatedEngine`` (``--simulated``: phase
timing and pool accounting only, no model execution).  Worker w runs on
card w % (cards on the host); ``--device`` defaults to ``cuda`` and raises
without a card, ``--device cpu`` runs the plain PyTorch path.

  PYTHONPATH=src python -m repro_torch.launch.cluster --arch qwen2-7b \
      --workers 2 --router pd --pd-split 1:1 --heartbeat-timeout 600
  PYTHONPATH=src python -m repro_torch.launch.cluster --arch qwen2-7b \
      --smoke --device cpu --workers 4 --router shaping --simulated

``--transport loopback`` runs the identical protocol in-process
(deterministic; the configuration the equivalence tests pin against the
in-process ``EventScheduler``).  ``--trace PATH`` writes a Chrome trace;
``tools/torch_trace_export.py --check PATH`` validates it.
"""
from __future__ import annotations

import argparse

import numpy as np

from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.core import hw
from repro_torch.device import resolve
from repro_torch.obs import (Tracer, format_summary, observe_phase_durations,
                             write_chrome)
from repro_torch.profiling import COST_MODELS
from repro_torch.serving import (ARRIVALS, LengthMix, RequestQueue, SloSpec,
                                 decode_cost, goodput_stats, make_trace,
                                 prefill_cost, schedule_arrivals)
from repro_torch.serving.cluster import (ROUTERS, TRANSPORTS, make_cluster,
                                         make_worker_specs)
from repro_torch.serving.trace_sim import phase_balanced_bandwidth


def build_cluster_args(ap: argparse.ArgumentParser) -> None:
    """The cluster axis flags, shared with ``serve.py`` (which also reuses
    the cost-model axis for its in-process fleet)."""
    ap.add_argument("--router", default="shaping", choices=list(ROUTERS),
                    help="request routing + prefill-grant policy: "
                         "round_robin (phase-aligned baseline), "
                         "shortest_backlog (join-shortest-backlog), "
                         "shaping (demand-aware cluster-wide stagger), "
                         "pd (prefill/decode disaggregation with KV-page "
                         "handoff; see --pd-split)")
    ap.add_argument("--pd-split", default=None, metavar="N:M",
                    help="with --router pd: pin N prefill workers and M "
                         "decode workers (N+M must equal the worker "
                         "count); default is an auto-rebalancing even "
                         "split")
    ap.add_argument("--transport", default="mp", choices=list(TRANSPORTS),
                    help="worker transport: 'mp' spawns one OS process per "
                         "worker over multiprocessing pipes; 'socket' "
                         "spawns the same workers dialing a TCP listener "
                         "(length-prefixed frames, the cross-host wire "
                         "format; see docs/multi_host.md); 'loopback' runs "
                         "the same protocol in-process (deterministic)")
    ap.add_argument("--heartbeat-timeout", type=float, default=60.0,
                    help="wall seconds of silence before a worker is "
                         "declared dead and its requests fail over")
    ap.add_argument("--cost-model", default="analytic",
                    choices=list(COST_MODELS),
                    help="phase pricing for the demand-shaping rule: "
                         "'analytic' derives durations from the per-layer "
                         "FLOPs/bytes decomposition (deterministic "
                         "default), 'measured' uses on-device wall-clock "
                         "EMAs with analytic cold-start fallback (see "
                         "docs/cost_models.md)")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="measured-cost calibration profile (JSON). With "
                         "--cost-model measured: an existing file is "
                         "loaded as a frozen, deterministic replay model; "
                         "serve.py (in-process) additionally writes the "
                         "profile after a live calibration run when the "
                         "file does not exist yet")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="automatic prefix caching in each engine's KV "
                         "pool: requests whose prompt shares a cached "
                         "prefix reference-share the resident blocks and "
                         "prefill only the divergent tail (copy-on-write, "
                         "LRU eviction under pool pressure; see "
                         "docs/prefix_caching.md).  Caches are per "
                         "engine/worker.  Requires the paged pool "
                         "(incompatible with --dense)")
    ap.add_argument("--kv-dtype", default="fp32",
                    choices=["fp32", "int8", "fp8"],
                    help="KV pool element layout: 'int8'/'fp8' pack pages "
                         "with per-(block, kv-head) scales, quartering the "
                         "decode KV stream vs fp32; the cost model prices "
                         "the reduced traffic (see docs/kv_quantization.md)."
                         "  Requires the paged pool (incompatible with "
                         "--dense)")
    ap.add_argument("--sparse-threshold", type=float, default=0.0,
                    metavar="T",
                    help="blockwise-sparse paged attention: skip KV blocks "
                         "whose estimated attention mass falls below T "
                         "(in [0, 1); 0 disables).  The block holding the "
                         "current token is always read.  Requires the "
                         "paged pool (incompatible with --dense)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export a Chrome-trace/Perfetto JSON of the run "
                         "to PATH: per-partition tracks with phase slices, "
                         "scheduler policy instants, PD handoff flow "
                         "arrows, and the aggregate bw-demand counter "
                         "track.  Load at https://ui.perfetto.dev; "
                         "validate with tools/torch_trace_export.py --check "
                         "(see docs/observability.md)")


def build_load_args(ap: argparse.ArgumentParser) -> None:
    """Open-loop offered-load axis (cluster CLI + soak benchmark only; the
    in-process ``serve.py`` stays closed-loop)."""
    ap.add_argument("--arrival", default="batch",
                    choices=["batch"] + list(ARRIVALS),
                    help="offered-load model: 'batch' queues --requests "
                         "up front at t=0 (closed-loop, the default); "
                         "poisson/diurnal/bursty inject a seeded open-loop "
                         "trace at virtual arrival instants (see "
                         "repro_torch.serving.loadgen and docs/multi_host.md)")
    ap.add_argument("--rps", type=float, default=1e6,
                    help="mean offered arrival rate in requests per "
                         "VIRTUAL second (the contention clock runs on a "
                         "microsecond scale for smoke workloads, so rates "
                         "are order 1e5-1e7); only with --arrival != batch")
    ap.add_argument("--horizon", type=float, default=None,
                    help="virtual seconds of offered load; default "
                         "--requests / --rps so --requests keeps meaning "
                         "'expected request count' in open-loop mode")
    ap.add_argument("--slo-ttft", type=float, default=None, metavar="S",
                    help="per-request SLO: virtual-seconds TTFT budget "
                         "(deadline = arrival + ttft + tpot * gen); "
                         "requires --arrival != batch")
    ap.add_argument("--slo-tpot", type=float, default=None, metavar="S",
                    help="per-request SLO: virtual-seconds per-decode-"
                         "token budget; requires --arrival != batch")


def validate_load_args(ap: argparse.ArgumentParser, args) -> None:
    """Parse-time validation of the offered-load axis."""
    if args.rps <= 0:
        ap.error(f"--rps must be > 0 requests per virtual second "
                 f"(got {args.rps})")
    if args.horizon is not None and args.horizon <= 0:
        ap.error(f"--horizon must be > 0 virtual seconds "
                 f"(got {args.horizon})")
    if args.arrival == "batch":
        for flag, val in (("--slo-ttft", args.slo_ttft),
                          ("--slo-tpot", args.slo_tpot)):
            if val is not None:
                ap.error(f"{flag} prices an open-loop arrival trace; with "
                         "--arrival batch use --deadline (an absolute "
                         "virtual-clock deadline) instead")
    for flag, val in (("--slo-ttft", args.slo_ttft),
                      ("--slo-tpot", args.slo_tpot)):
        if val is not None and val <= 0:
            ap.error(f"{flag} must be > 0 virtual seconds (got {val})")


def validate_cluster_args(ap: argparse.ArgumentParser, args) -> None:
    """Parse-time validation of the shared cluster axis (both CLIs call
    this so a bad flag dies with ``ap.error`` instead of a downstream
    stack trace).  Rewrites ``args.pd_split`` from "N:M" to a tuple."""
    if args.heartbeat_timeout <= 0:
        ap.error(f"--heartbeat-timeout must be > 0 wall seconds (got "
                 f"{args.heartbeat_timeout}); a non-positive timeout "
                 "would declare every worker dead at its first recv")
    if args.profile is not None and args.cost_model != "measured":
        ap.error("--profile only applies to --cost-model measured; the "
                 "analytic model never reads a profile")
    if getattr(args, "prefix_cache", False) and getattr(args, "dense", False):
        ap.error("--prefix-cache shares KV *blocks* and needs the paged "
                 "pool; it cannot be combined with --dense")
    if not 0.0 <= args.sparse_threshold < 1.0:
        ap.error(f"--sparse-threshold must be in [0, 1) (got "
                 f"{args.sparse_threshold}): it is a per-block attention-"
                 "mass cutoff and >= 1 would drop every block")
    if getattr(args, "dense", False):
        if args.kv_dtype != "fp32":
            ap.error("--kv-dtype int8/fp8 packs paged KV *blocks* and "
                     "needs the paged pool; it cannot be combined with "
                     "--dense")
        if args.sparse_threshold > 0.0:
            ap.error("--sparse-threshold skips paged KV *blocks* and "
                     "needs the paged pool; it cannot be combined with "
                     "--dense")
    if args.pd_split is not None:
        if args.router != "pd":
            ap.error(f"--pd-split only applies to --router pd "
                     f"(got --router {args.router})")
        try:
            n_pre, n_dec = (int(s) for s in args.pd_split.split(":"))
        except ValueError:
            ap.error(f"--pd-split must be N:M (two integers, got "
                     f"{args.pd_split!r})")
        if n_pre < 1 or n_dec < 1:
            ap.error(f"--pd-split needs at least one worker per pool "
                     f"(got {args.pd_split})")
        args.pd_split = (n_pre, n_dec)


def run_cluster(*, arch: str, smoke: bool, workers: int, slots: int,
                prompt_len: int, gen: int, n_requests: int, router: str,
                transport: str, simulated: bool, block_size: int = 16,
                dense: bool = False, heartbeat_timeout: float = 60.0,
                max_queue=None, deadline=None, seed: int = 0,
                quiet: bool = False, cost_model: str = "analytic",
                profile=None, pd_split=None, prefix_cache: bool = False,
                kv_dtype: str = "fp32", sparse_threshold: float = 0.0,
                trace=None, arrival: str = "batch", rps: float = 1e6,
                horizon=None, slo_ttft=None, slo_tpot=None,
                device: str = "cuda"):
    """Build the request load + worker fleet, run it, print the summary.
    ``arrival='batch'`` queues ``n_requests`` at t=0 (closed-loop);
    poisson/diurnal/bursty inject an open-loop ``loadgen`` trace at virtual
    arrival instants and report goodput.  ``device`` is where real workers
    run (``"cuda"``: worker w on card w % count).  Returns (controller,
    metrics)."""
    if profile is not None and cost_model != "measured":
        raise ValueError(
            f"--profile {profile} only applies to --cost-model measured; "
            f"the {cost_model!r} model never reads a profile")
    if profile is not None and not Path(profile).exists():
        # cluster workers cannot merge N live timers into one file; a
        # cluster --profile is therefore replay-only — calibrate first with
        # the in-process CLI (serve.py --cost-model measured --profile ...)
        raise FileNotFoundError(
            f"--profile {profile} does not exist; calibrate it first with "
            f"the in-process fleet: python -m repro_torch.launch.serve "
            f"--cost-model measured --profile {profile} ...")
    if simulated and cost_model == "measured" and profile is None:
        # fail here with the full story rather than letting every worker
        # die at build_engine (under --transport mp that would surface as
        # an opaque handshake failure)
        raise ValueError(
            "--simulated --cost-model measured needs --profile PATH: a "
            "simulated engine has no device to time, so measured pricing "
            "is replay-only (calibrate with serve.py first)")
    if pd_split is not None:
        if router != "pd":
            raise ValueError(f"pd_split={pd_split} only applies to "
                             f"router='pd' (got {router!r})")
        if sum(pd_split) != workers:
            raise ValueError(
                f"pd split {pd_split[0]}:{pd_split[1]} does not cover the "
                f"{workers}-worker fleet")
    if router == "pd":
        from repro_torch.serving.pd import PdRouter
        router_arg = PdRouter(split=pd_split)
    else:
        router_arg = router
    cfg = get_config(arch, smoke=smoke)
    peak_per_worker = hw.H100_PEAK_FLOPS / workers
    # open-loop length mixes are heavy-tailed up to 2x the nominal lengths,
    # so the worker context budget follows the caps, not the medians
    p_cap = prompt_len if arrival == "batch" else 2 * prompt_len
    g_cap = gen if arrival == "batch" else 2 * gen
    max_len = p_cap + 4 * g_cap + (cfg.n_meta_tokens or 0) + \
        (cfg.n_img_tokens or 0)

    if prefix_cache and dense:
        raise ValueError("prefix_cache shares KV blocks and needs the "
                         "paged pool; it cannot be combined with dense")
    if (kv_dtype != "fp32" or sparse_threshold > 0.0) and dense:
        raise ValueError("kv quantization / blockwise-sparse attention "
                         "live in the paged block pool; they cannot be "
                         "combined with dense")

    def estimate(req):
        # req.cached_len is 0 controller-side (worker pools are remote, so
        # there is no admission-time probe in cluster mode); priced through
        # anyway so a future cross-process probe needs no change here
        pre = prefill_cost(cfg, slots, req.prompt_len, peak_per_worker,
                           cached=req.cached_len)
        dec = decode_cost(cfg, slots, req.prompt_len + gen // 2,
                          peak_per_worker)
        return pre.duration + req.max_new_tokens * dec.duration

    queue = RequestQueue(max_depth=max_queue, service_estimate=estimate)
    # the tracer must watch the queue BEFORE the load goes in, so the
    # admission instants and lifecycle 'submit' records are captured
    tracer = None
    if trace is not None:
        tracer = Tracer()
        queue.tracer = tracer
    offered = None
    if arrival == "batch":
        rng = np.random.default_rng(seed)
        for _ in range(n_requests):
            queue.submit(rng.integers(1, cfg.vocab, size=(prompt_len,))
                         .astype(np.int32), gen, arrival=0.0,
                         deadline=deadline)
    else:
        slo = None
        if slo_ttft is not None or slo_tpot is not None:
            slo = SloSpec(ttft_budget=slo_ttft or 0.0,
                          tpot_budget=slo_tpot or 0.0)
        mix = LengthMix(prompt_median=prompt_len,
                        prompt_min=max(1, prompt_len // 4),
                        prompt_max=p_cap, gen_median=gen, gen_min=1,
                        gen_max=g_cap)
        if horizon is None:
            horizon = n_requests / rps  # --requests = expected count
        offered = make_trace(arrival, rps, horizon, seed=seed, mix=mix,
                             slo=slo, vocab=cfg.vocab)

    bandwidth = phase_balanced_bandwidth(
        cfg, total_slots=workers * slots, prompt_len=prompt_len, gen=gen)
    specs = make_worker_specs(
        arch, workers, smoke=smoke, slots=slots, max_len=max_len,
        engine="sim" if simulated else "real", block_size=block_size,
        paged=False if dense else None, seed=seed,
        cost_model=cost_model,
        profile=str(profile) if profile is not None else None,
        prefix_cache=prefix_cache, kv_dtype=kv_dtype,
        sparse_threshold=sparse_threshold, device=device)
    ctl = make_cluster(specs, queue, transport=transport, router=router_arg,
                       bandwidth=bandwidth,
                       heartbeat_timeout=heartbeat_timeout)
    if tracer is not None:
        ctl.attach_tracer(tracer)
    if offered is not None:
        # open-loop: requests land on the virtual clock whether or not the
        # fleet keeps up; ctl.run() drains arrivals and service together
        schedule_arrivals(ctl.timeline, queue, offered,
                          on_arrival=ctl.pump)
    m = ctl.run()
    if not quiet:
        s = m.summary()
        pd_note = ""
        if router == "pd":
            r = ctl.router
            n_pre = sum(1 for p in r.pool_of.values() if p == "prefill")
            pd_note = (f" split={n_pre}:{len(r.pool_of) - n_pre} "
                       f"handoffs={r.n_handoffs} deferrals={r.n_deferrals}")
        print(f"cluster: {cfg.name} workers={workers} router={router}"
              f"{pd_note} "
              f"transport={transport} slots={workers}x{slots} "
              f"cost_model={cost_model} "
              f"prefix_cache={'on' if prefix_cache else 'off'} "
              f"kv={kv_dtype} sparse={sparse_threshold:g} "
              f"completed={s['requests_completed']}/{queue.n_submitted} "
              f"rejected={queue.n_rejected} requeued={queue.n_requeued} "
              f"failovers={ctl.n_failovers}")
        if offered is not None:
            gs = goodput_stats(queue)
            print(f"  load: arrival={arrival} rps={rps:g} "
                  f"horizon={horizon:g} offered={int(gs['offered'])} "
                  f"attained={int(gs['attained'])} late={int(gs['late'])} "
                  f"goodput={gs['goodput']:.3f}")
        # the shared summary formatter (repro_torch.obs.format_summary): the
        # fleet registry comes from the worker snapshots piggybacked on
        # WorkerStatus, so the cluster CLI reports the same prefix-cache
        # counters the in-process CLI always had
        reg = ctl.fleet_registry()
        observe_phase_durations(reg, ctl.trace)
        reg.inc("queue.submitted", queue.n_submitted)
        reg.inc("queue.rejected", queue.n_rejected)
        reg.inc("queue.requeued", queue.n_requeued)
        lifecycle = tracer.lifecycle.format_exit_line() \
            if tracer is not None else None
        for line in format_summary(s, reg, bandwidth=bandwidth,
                                   achieved=ctl.achieved_bw_stats(),
                                   prefix_cache=prefix_cache,
                                   lifecycle=lifecycle):
            print(line)
    if tracer is not None:
        doc = write_chrome(tracer, trace)
        if not quiet:
            print(f"  trace: {len(doc['traceEvents'])} events -> {trace}")
    return ctl, m


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where real workers run; 'cuda' (the default) "
                         "puts worker w on card w %% count and raises "
                         "when there is no card")
    ap.add_argument("--workers", type=int, default=4,
                    help="partition worker count (the paper's P)")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots per worker")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--dense", action="store_true",
                    help="dense per-wave KV layout instead of the paged "
                         "pool (the equivalence oracle)")
    ap.add_argument("--simulated", action="store_true",
                    help="SimulatedEngine workers (no model execution)")
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--deadline", type=float, default=None)
    build_cluster_args(ap)
    build_load_args(ap)
    args = ap.parse_args(argv)
    if args.workers < 1:
        ap.error(f"--workers must be >= 1 (got {args.workers})")
    if args.batch < 1:
        ap.error(f"--batch must be >= 1 (got {args.batch})")
    if args.requests < 1:
        ap.error(f"--requests must be >= 1 (got {args.requests})")
    validate_cluster_args(ap, args)
    validate_load_args(ap, args)
    if args.pd_split is not None and sum(args.pd_split) != args.workers:
        ap.error(f"--pd-split {args.pd_split[0]}:{args.pd_split[1]} does "
                 f"not cover the {args.workers}-worker fleet")
    resolve(args.device)   # no card: raise here, not in every worker
    run_cluster(arch=args.arch, smoke=args.smoke, workers=args.workers,
                slots=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                n_requests=args.requests, router=args.router,
                transport=args.transport, simulated=args.simulated,
                block_size=args.block_size, dense=args.dense,
                heartbeat_timeout=args.heartbeat_timeout,
                max_queue=args.max_queue, deadline=args.deadline,
                cost_model=args.cost_model, profile=args.profile,
                pd_split=args.pd_split, prefix_cache=args.prefix_cache,
                kv_dtype=args.kv_dtype,
                sparse_threshold=args.sparse_threshold, trace=args.trace,
                arrival=args.arrival, rps=args.rps, horizon=args.horizon,
                slo_ttft=args.slo_ttft, slo_tpot=args.slo_tpot,
                device=args.device)


if __name__ == "__main__":
    main()
