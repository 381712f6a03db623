"""End to end (PyTorch port): the paper's Europarl experiment,
faithfully staged.

Pipeline (paper §4):
  1. paired "sentences" → bag-of-words → feature hashing into d slots
     per view (Weinberger et al. hashing, the paper uses 2^19 slots);
  2. RandomizedCCA (Algorithm 1) over the hashed views, streaming the
     corpus in row chunks (out-of-core semantics, q+1 data passes);
  3. report the objective on train and test rows, and the Horst+rcca
     warm-start comparison (paper Table 2b).

Scaled down: n = 20k synthetic paired docs, 2^12 hash slots.  The port
of ``examples/europarl_cca.py``; it runs on the card, with the
hand-written kernels, unless ``--device cpu`` is given.

With ``--store DIR`` the hashed views are ingested once into an on-disk
view store (``repro_torch.store``) and the fit streams from disk through
the prefetching ``PassRunner`` — the paper's out-of-core setting:
featurize once, then any number of experiments re-read the store
instead of re-hashing.

    PYTHONPATH=src python examples/europarl_cca_torch.py [--device cpu] [--store DIR]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import HorstConfig, cca_objective, horst_cca
from repro_torch.core.rcca import RCCAConfig, randomized_cca_iterator
from repro_torch.data import HashingFeaturizer
from repro_torch.device import resolve_device


def synth_paired_docs(n, vocab=50_000, doc_len=30, seed=0):
    """Paired 'translations': view B's tokens are a deterministic map of
    view A's plus noise — so the views share latent structure exactly
    like sentence-aligned Europarl."""
    rng = np.random.default_rng(seed)
    # zipfian-ish token draws
    base = rng.zipf(1.3, size=(n, doc_len)).clip(1, vocab - 1)
    noise_mask = rng.random((n, doc_len)) < 0.2
    other = rng.zipf(1.3, size=(n, doc_len)).clip(1, vocab - 1)
    paired = np.where(noise_mask, other, (base * 2_654_435_761) % vocab + 1)  # a fixed "dictionary"
    return base.astype(np.int64), paired.astype(np.int64)


def _store_reader(path, chunks, n_tr, slots, chunk):
    """The view store at ``path``: ingested from ``chunks`` when absent,
    else reused if it holds the flags' rows."""
    import os

    from repro_torch.store import ViewStoreReader, ingest_chunks
    from repro_torch.store.format import MANIFEST

    if not os.path.exists(os.path.join(path, MANIFEST)):
        reader = ingest_chunks(path, chunks, chunk=chunk)
        print(f"      ingested {reader.n} hashed rows ({reader.nbytes / 1e6:.1f} MB) → {path}")
        return reader
    reader = ViewStoreReader(path)
    if (reader.n, reader.da, reader.db) != (n_tr, slots, slots):
        raise SystemExit(
            f"view store {path} holds n={reader.n} da={reader.da} db={reader.db} but the "
            f"flags ask for n={n_tr} slots={slots} — point --store at a fresh directory "
            "(or delete it) to re-ingest")
    print(f"      reusing view store {path} (n={reader.n})")
    return reader


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--slots", type=int, default=4096)  # paper: 2**19
    ap.add_argument("--k", type=int, default=16)        # paper: 60
    ap.add_argument("--p", type=int, default=64)        # paper: 910/2000
    ap.add_argument("--q", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="ingest the hashed train views into an on-disk view store and fit "
                         "from it (out-of-core path with async prefetch)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"[1/3] hashing {args.n} paired docs into 2×{args.slots} slots...")
    docs_a, docs_b = synth_paired_docs(args.n)
    ha = HashingFeaturizer(args.slots, seed=1)
    hb = HashingFeaturizer(args.slots, seed=2)
    n_tr = int(args.n * 0.9)

    def chunks(lo, hi):
        for s in range(lo, hi, args.chunk):
            e = min(s + args.chunk, hi)
            yield ha.featurize_batch(docs_a[s:e]), hb.featurize_batch(docs_b[s:e])

    print(f"[2/3] RandomizedCCA k={args.k} p={args.p} q={args.q} "
          f"({args.q + 1} data passes, streamed, on {dev})...")
    cfg = RCCAConfig(k=args.k, p=args.p, q=args.q, nu=0.01, center=True)
    t0 = time.time()
    if args.store:
        from repro_torch.store import PassRunner

        reader = _store_reader(args.store, chunks(0, n_tr), n_tr, args.slots, args.chunk)
        runner = PassRunner(reader, cfg, device=dev)
        try:
            res = runner.fit(seed=0)
        finally:
            runner.close()
        print(f"      io: {res.diagnostics['io']['passes']}")
    else:
        res = randomized_cca_iterator(lambda: chunks(0, n_tr), args.slots, args.slots, cfg,
                                      seed=0, device=dev)
    sum_rho = float(res.rho.sum())
    print(f"      done in {time.time() - t0:.1f}s; sum rho = {sum_rho:.4f}")

    # evaluate train/test objective on materialized matrices (small scale)
    def rows(lo, hi):
        As, Bs = zip(*chunks(lo, hi))
        return (torch.as_tensor(np.concatenate(As), device=dev),
                torch.as_tensor(np.concatenate(Bs), device=dev))

    A_tr, B_tr = rows(0, n_tr)
    A_te, B_te = rows(n_tr, args.n)
    mu_a, mu_b = A_tr.mean(0), B_tr.mean(0)
    A_tr, B_tr = A_tr - mu_a, B_tr - mu_b
    tr = float(cca_objective(A_tr, B_tr, res.Xa, res.Xb))
    te = float(cca_objective(A_te - mu_a, B_te - mu_b, res.Xa, res.Xb))
    print(f"      objective: train {tr:.4f} / test {te:.4f}")

    print("[3/3] Horst+rcca warm start (paper Table 2b)...")
    t0 = time.time()
    h = horst_cca(A_tr, B_tr, HorstConfig(k=args.k, iters=10, nu=0.01), init_Xb=res.Xb,
                  device=dev)
    tr_h = float(cca_objective(A_tr, B_tr, h.Xa, h.Xb))
    print(f"      10 Horst iterations from rcca init: train {tr_h:.4f} "
          f"(+{tr_h - tr:.4f}) in {time.time() - t0:.1f}s")
    out = {"sum_rho": sum_rho, "train": tr, "test": te, "horst_train": tr_h,
           "horst_rho": h.rho}
    if not all(np.isfinite([sum_rho, tr, te, tr_h])) or not bool(torch.isfinite(h.rho).all()):
        raise AssertionError(f"non-finite result: {out}")
    print("OK")
    return out


if __name__ == "__main__":
    main()
