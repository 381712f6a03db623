"""Quickstart (PyTorch port): RandomizedCCA on a planted two-view corpus,
validated against the exact dense oracle.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The port of ``examples/quickstart.py``; it runs on the card unless
``--device cpu`` is given.
"""

import argparse

import torch

from repro_torch.core import draw_omega, exact_cca, feasibility_errors, randomized_cca
from repro_torch.core.rcca import RCCAConfig
from repro_torch.data import planted_views
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # two views with a shared 8-dim latent
    A, B = planted_views(0, n=4000, da=64, db=48, rank=8, noise=0.4)
    A = torch.as_tensor(A, dtype=torch.float32, device=dev)
    B = torch.as_tensor(B, dtype=torch.float32, device=dev)

    cfg = RCCAConfig(k=6, p=32, q=1, nu=0.01)
    Qa, Qb = draw_omega(0, A.shape[1], B.shape[1], cfg, device=dev)
    result = randomized_cca(A, B, cfg, Qa, Qb, device=dev)
    print("canonical correlations:", [f"{r:.4f}" for r in result.rho.tolist()])

    lam_a = float(result.diagnostics["lam_a"])
    lam_b = float(result.diagnostics["lam_b"])
    exact = exact_cca(A, B, cfg.k, lam_a, lam_b)
    print("exact oracle:          ", [f"{r:.4f}" for r in exact.rho.tolist()])

    errs = feasibility_errors(A, B, result.Xa, result.Xb, lam_a, lam_b)
    print("feasibility residuals: ", {k: f"{float(v):.2e}" for k, v in errs.items()})

    gap = float(exact.rho.sum() - result.rho.sum())
    print(f"objective gap vs exact: {gap:.5f}")
    if not gap < 0.05:
        raise AssertionError("RandomizedCCA should be near-exact at this scale")
    print("OK")
    return {"sum_rho": float(result.rho.sum()), "gap": gap}


if __name__ == "__main__":
    main()
