"""The paper's technique × the model zoo (PyTorch port): align the
representations of two different LMs over paired text with the
streaming RandomizedCCA.

This is the modern analogue of the paper's multilingual-embedding
application: view A = model 1's hidden states, view B = model 2's
hidden states of the same token stream; CCA finds the shared subspace.
Also demonstrates SVCCA-style layer analysis within one model.

The port of ``examples/activation_cca.py``, on the smoke configs of
granite-3-2b and gemma3-1b (vocabularies aligned so that both read one
stream, as there).  It runs on the card, the models' products in
PyTorch and the fit's data passes in the hand-written kernels, unless
``--device cpu`` is given.

    PYTHONPATH=src python examples/activation_cca_torch.py [--device cpu]
"""

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core import randomized_cca
from repro_torch.core.harvest import activation_views, layer_views, paired_activation_stream
from repro_torch.core.rcca import RCCAConfig, draw_omega, randomized_cca_iterator
from repro_torch.data import SyntheticTokenStream
from repro_torch.device import resolve_device
from repro_torch.models import build_model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg1 = get_config("granite-3-2b", smoke=True)
    cfg2 = get_config("gemma3-1b", smoke=True)  # different family!
    # same vocab so both can read the same stream
    cfg2 = dataclasses.replace(cfg2, vocab=cfg1.vocab)

    m1, m2 = build_model(cfg1, device=dev, seed=0), build_model(cfg2, device=dev, seed=1)

    stream = SyntheticTokenStream(vocab=cfg1.vocab, batch=8, seq=32, seed=3)
    batches = [{"tokens": torch.from_numpy(stream.get_batch(i)[:, :-1]).to(dev)}
               for i in range(8)]

    print("[1/2] streaming activation harvest → RandomizedCCA "
          f"(views: {cfg1.name} vs {cfg2.name})")
    da = cfg1.d_model
    db = cfg2.d_model
    cfg = RCCAConfig(k=8, p=24, q=1, nu=0.01, center=True)
    res = randomized_cca_iterator(
        lambda: paired_activation_stream(m1, m2, iter(batches)),
        da, db, cfg, seed=4, device=dev,
    )
    print(f"      cross-model canonical correlations: {[f'{r:.3f}' for r in res.rho.tolist()]}")

    # negative control: break the row ALIGNMENT (CCA finds aligned
    # structure; shuffling one view's rows destroys it — token AND
    # positional correlation both vanish)
    def shuffled_pairs():
        for i, b in enumerate(batches):
            va = activation_views(m1, b)
            vb = activation_views(m2, b)
            g = torch.Generator(device=dev)
            g.manual_seed(40 + i)
            perm = torch.randperm(vb.shape[0], generator=g, device=dev)
            yield va, vb[perm]

    res0 = randomized_cca_iterator(shuffled_pairs, da, db, cfg, seed=4, device=dev)
    print(f"      shuffled-alignment control:          "
          f"{[f'{r:.3f}' for r in res0.rho.tolist()]}")
    gap = float(res.rho.double().sum() - res0.rho.double().sum())
    print(f"      aligned-vs-shuffled gap: {gap:.3f} (should be >> 0)")
    if not gap > 0.5:
        raise RuntimeError(f"aligned-vs-shuffled gap {gap:.3f} is not above 0.5")

    print("[2/2] SVCCA-style: same model, half depth vs full depth")
    A = activation_views(m1, batches[0])
    Ahalf = layer_views(m1, batches[0], 0.5)
    scfg = RCCAConfig(k=8, p=16, q=1, nu=0.01)
    Qa, Qb = draw_omega(5, da, da, scfg, device=dev)
    r = randomized_cca(Ahalf, A, scfg, Qa, Qb, device=dev)
    print(f"      depth-0.5 vs depth-1.0 correlations: {[f'{x:.3f}' for x in r.rho.tolist()]}")
    print("OK")
    return {"rho": res.rho, "rho_shuffled": res0.rho, "gap": gap, "rho_depth": r.rho}


if __name__ == "__main__":
    main()
