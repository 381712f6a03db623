"""Serving-loop driver: fit → publish → serve → drift → delta-refit → swap.

    PYTHONPATH=src python -m repro_torch.launch.cca_serve --smoke --device cpu \
        --store /tmp/cca_store --registry /tmp/cca_registry
    PYTHONPATH=src python -m repro_torch.launch.cca_serve --smoke \
        --store /tmp/cca_store --registry /tmp/cca_registry  # on the card

Port of ``repro/launch/cca_serve.py``: one process walks the serving
story of :mod:`repro_torch.serve`, in the reference's six stages and with
its ``[serve]`` lines:

1. ingest the first tranche of a synthetic paired-view corpus
   (:class:`~repro_torch.data.PlantedCCAData`, chunk for chunk the
   reference's rows) into a view store and fit it with
   :func:`repro_torch.exec.fit_with_state`, which keeps the accumulator
   state for later delta-refits;
2. publish the model as **v1** of a :class:`~repro_torch.serve.ModelRegistry`
   entry and persist the :class:`~repro_torch.exec.FitState` beside it;
3. serve traffic through a :class:`~repro_torch.serve.BatchedProjector`
   while a :class:`~repro_torch.serve.DriftMonitor` watches paired
   held-out rows, and answer a cross-view top-5 from a
   :class:`~repro_torch.serve.CorpusIndex` of the store;
4. inject a distribution shift (the held-out pairing breaks): the
   correlation collapses and the monitor raises the refit signal;
5. append the second tranche to the store and
   :func:`repro_torch.exec.delta_refit` it (``mode="exact"``: bitwise the
   cold fit of the grown corpus);
6. publish **v2** and hot-swap the projector under concurrent clients —
   zero dropped requests, both versions seen — then re-baseline the
   monitor and show the held-out correlation recovered.

Beyond the reference's flags: ``--device`` (the card by default; ``cpu``
runs the plain versions), ``--engine kernels|torch`` (the projection and
the fit's per-chunk update: the CUDA kernels, or ``torch.matmul`` and the
plain updates).  ``--trace [DIR]`` records a ``repro_torch.obs`` trace
(``RCCA_TRACE``, default directory ``rcca_trace/``): the fit's and the
refit's spans, the serving spans and the drift, swap, occupancy and
registry counters; the report is printed at the end.  ``--topology
sharded`` fits and refits with merge groups folded one per device slot
(``--devices``: a count or a slot list such as ``cuda:0,cuda:0``;
default every card, or one host slot): bitwise the local fit.  Exits
non-zero when
the drift is not flagged, a request is dropped, the swap does not show
both versions, or the correlation does not recover.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from .. import obs
from ..core.rcca import DEFAULT_ENGINE, OMEGA_MODES, RCCAConfig
from ..data.synthetic import PlantedCCAData
from ..device import DEFAULT_DEVICE, resolve_device


def _fitstate_dir(registry_root: str, name: str) -> str:
    return os.path.join(registry_root, name, "fitstate")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny corpus (seconds on the CPU): the demo scale")
    ap.add_argument("--store", required=True, help="view store path (created/extended here)")
    ap.add_argument("--registry", required=True,
                    help="model registry root (repro_torch.serve.ModelRegistry)")
    ap.add_argument("--name", default="europarl-cca", help="registry model name")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="'cuda' (default) or 'cpu' (the kernels' plain versions)")
    ap.add_argument("--engine", default=DEFAULT_ENGINE, choices=["kernels", "torch"])
    ap.add_argument("--omega", default="materialized", choices=list(OMEGA_MODES))
    ap.add_argument("--topology", default="local", choices=["local", "sharded"],
                    help="fit/refit topology (sharded: merge groups one per device slot)")
    ap.add_argument("--devices", default=None,
                    help="sharded: the device slots, a count or a list such as cuda:0,cuda:0")
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--q", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--window", type=int, default=192, help="drift-monitor window (held-out rows)")
    ap.add_argument("--threshold", type=float, default=0.8,
                    help="refit signal fires below this fraction of the baseline correlation")
    ap.add_argument("--clients", type=int, default=16,
                    help="concurrent request threads during the swap")
    ap.add_argument("--prune-keep", type=int, default=None, metavar="N",
                    help="after the final publish, garbage-collect old registry versions "
                         "keeping the newest N (the current version and its rollback target "
                         "are always kept)")
    ap.add_argument("--trace", default=None, metavar="DIR", nargs="?", const="1",
                    help="record a repro_torch.obs trace (spans of the fit, the refit and "
                         "the serve batches; drift, swap, occupancy and registry counters) "
                         "and print its report at the end; DIR defaults to rcca_trace/")
    return ap.parse_args(argv)


def serve(args: argparse.Namespace) -> dict:
    """The six stages → a report: versions, Σρ, drift means, the swap's
    versions seen and dropped requests, projector stats and timings."""
    from ..exec import FitState, Local, Sharded, delta_refit, fit_with_state
    from ..serve import BatchedProjector, CorpusIndex, DriftMonitor, ModelRegistry
    from ..store import ViewStoreReader, extend_chunks, ingest_chunks, store_exists

    if args.trace:
        os.environ[obs.TRACE_ENV] = args.trace
        print(f"[serve] tracing -> {obs.trace_dir()}/", flush=True)
    dev = resolve_device(args.device)
    topology = Local() if args.topology == "local" else Sharded(devices=args.devices)

    # -- corpus geometry: two tranches + held-out traffic -----------------
    # the first tranche ends on a merge-group boundary (the delta refit's
    # alignment contract)
    if args.smoke:
        chunk, merge_group = 128, 2
        n0, n1, n_traffic = 1024, 1536, 1024
        cfg = RCCAConfig(k=4, p=8, q=1, nu=0.01, center=True)
    else:
        chunk, merge_group = 1024, 8
        n0, n1, n_traffic = 65536, 98304, 8192
        cfg = RCCAConfig(k=16, p=16, q=1, nu=0.01, center=True)
    if args.k is not None:
        cfg = dataclasses.replace(cfg, k=args.k)
    if args.q is not None:
        cfg = dataclasses.replace(cfg, q=args.q)
    da, db = (28, 20) if args.smoke else (160, 120)
    data = PlantedCCAData(n=n1 + n_traffic, da=da, db=db, rank=max(cfg.k * 2, 8), noise=0.4,
                          seed=11 + args.seed, chunk=chunk)
    c0, c1 = n0 // chunk, n1 // chunk
    reg = ModelRegistry(args.registry)
    rep: dict = {}

    # -- 1+2: first tranche → stateful fit → publish v1 -------------------
    if not store_exists(args.store):
        ingest_chunks(args.store, (data.get_chunk(i) for i in range(c0)), chunk=chunk)
    reader = ViewStoreReader(args.store)
    print(f"[serve] store {args.store}: n={reader.n} da={reader.da} db={reader.db} "
          f"({reader.n_chunks} chunks)", flush=True)
    t0 = time.time()
    res, state = fit_with_state(reader, cfg, args.seed, engine=args.engine, omega=args.omega,
                                merge_group=merge_group, device=dev, topology=topology)
    v1 = reg.publish(args.name, res, fit_meta=state.meta)
    state.save(_fitstate_dir(args.registry, args.name))
    rep["sum_rho_v1"] = float(res.rho.double().sum())
    print(f"[serve] fit tranche 1 in {time.time() - t0:.1f}s; published {args.name} v{v1} "
          f"(sum rho = {rep['sum_rho_v1']:.4f})", flush=True)
    del res, state

    # -- 3: serve + monitor -----------------------------------------------
    model = reg.load(args.name, device=dev)
    proj = BatchedProjector(model, max_batch=32, engine=args.engine)
    try:
        monitor = DriftMonitor(model, window=args.window, threshold=args.threshold,
                               engine=args.engine)
        index = CorpusIndex.from_store(model, reader, view="b", engine=args.engine)

        # held-out traffic: rows past every corpus tranche, enough to fill
        # the drift window
        parts = [data.get_chunk(i) for i in range(c1, c1 + -(-args.window // chunk))]
        xa_t = np.concatenate([a for a, _ in parts]).astype(np.float32)
        xb_t = np.concatenate([b for _, b in parts]).astype(np.float32)
        for lo in range(0, args.window, 64):
            monitor.observe(xa_t[lo:lo + 64], xb_t[lo:lo + 64])
        baseline = monitor.baseline
        print(f"[serve] baseline held-out correlation: {baseline:.4f} "
              f"(window={args.window})", flush=True)
        r = proj.project_a(xa_t[0])
        hits, _ = index.topk(r["emb"], k=5)
        print(f"[serve] sample request: v{r['version']} top-5 cross-view rows {hits.tolist()}",
              flush=True)

        # -- 4: inject shift → drift signal -----------------------------------
        perm = np.random.default_rng(7).permutation(xb_t.shape[0])
        shifted = xb_t[perm]  # pairing broken: an upstream pipeline "change"
        mean = None
        for lo in range(0, args.window, 64):
            mean = monitor.observe(xa_t[lo:lo + 64], shifted[lo:lo + 64]) or mean
        print(f"[serve] injected shift: correlation {mean:.4f} -> "
              f"refit_needed={monitor.refit_needed}", flush=True)
        if not monitor.refit_needed:
            raise SystemExit("drift monitor failed to flag the injected shift")

        # -- 5: append tranche 2 + delta-refit --------------------------------
        t0 = time.time()
        extend_chunks(args.store, (data.get_chunk(i) for i in range(c0, c1)))
        reader = ViewStoreReader(args.store)
        state = FitState.load(_fitstate_dir(args.registry, args.name))
        res2, state2 = delta_refit(state, reader, mode="exact", device=dev,
                                   topology=topology)
        d = res2.diagnostics["delta"]
        rep["sum_rho_v2"] = float(res2.rho.double().sum())
        print(f"[serve] delta-refit in {time.time() - t0:.1f}s: +{reader.n - n0} rows, "
              f"delta_chunks={d['delta_chunks']}, refolded={d['refolded_chunks']} "
              f"(sum rho = {rep['sum_rho_v2']:.4f})", flush=True)

        # -- 6: publish v2 + hot-swap under live traffic ----------------------
        v2 = reg.publish(args.name, res2, fit_meta=state2.meta, parent=v1)
        state2.save(_fitstate_dir(args.registry, args.name))
        del res2, state, state2
        model2 = reg.load(args.name, device=dev)

        def client(i: int) -> int:
            return proj.project_a(xa_t[i % xa_t.shape[0]])["version"]

        with ThreadPoolExecutor(max_workers=8) as pool:
            futs = [pool.submit(client, i) for i in range(args.clients)]
            futs[0].result()  # traffic is flowing under v1 when the swap comes
            proj.swap(model2)
            futs += [pool.submit(client, i) for i in range(args.clients)]
            served = [f.result() for f in futs]
        versions = sorted(set(served))
        dropped = 2 * args.clients - len(served)
        stats = proj.stats()
        print(f"[serve] hot-swap v{v1}->v{v2}: {len(served)} responses across the flip "
              f"(versions seen: {versions}, dropped: {dropped}); batches={stats['batches']} "
              f"mean_occupancy={stats['mean_occupancy']:.1f} swaps={stats['swaps']}",
              flush=True)

        # -- recovery: healthy traffic under the refreshed model --------------
        monitor.rebind(model2)
        recovered = None
        for lo in range(0, args.window, 64):
            recovered = monitor.observe(xa_t[lo:lo + 64], xb_t[lo:lo + 64]) or recovered
        print(f"[serve] post-swap held-out correlation: {recovered:.4f} "
              f"(refit_needed={monitor.refit_needed})", flush=True)
    finally:
        proj.close()

    if args.prune_keep is not None:
        pruned = reg.prune(args.name, keep=args.prune_keep)
        print(f"[serve] pruned versions {pruned} (keep={args.prune_keep})", flush=True)
    if args.trace:
        from ..obs import report as obs_report

        print(obs_report.render(obs_report.analyze(obs.trace_dir())), flush=True)
    print(f"[serve] registry {args.registry}: {args.name} versions {reg.versions(args.name)}, "
          f"current v{reg.current_version(args.name)}", flush=True)
    rep.update(v1=v1, v2=v2, baseline=baseline, shifted=mean, recovered=recovered,
               drift_flagged=True, versions_seen=versions, dropped=dropped, projector=stats,
               delta=d)
    if dropped or versions != [v1, v2]:
        raise SystemExit(f"hot swap: versions seen {versions}, {dropped} dropped")
    if not recovered >= args.threshold * baseline:
        raise SystemExit(f"held-out correlation did not recover: {recovered:.4f} against "
                         f"{args.threshold} × {baseline:.4f}")
    return rep


def main(argv=None) -> int:
    serve(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
