"""A witness for RWKV6-3B's gradients at full width, on the CPU.

The JAX package's ``jax.value_and_grad(model.train_loss)`` against the
port's ``launch.steps.loss_and_grads`` on the same weights (the reference's
``init(PRNGKey(0))``, carried across by ``convert.lm_params_from_reference``)
and the same tokens (the pipeline's batch 0, its first row: one microbatch
of 128 tokens, as the first microbatch of the card's training step), in
float32 compute, at the config's full width and ``--layers`` layers.
Beside it, each weight leaf's spread under the two packages' own inits
(``init(0)``: different random numbers, the same distributions) and the
gradient norm that the port's own init gives.

    PYTHONPATH=src python tests/witness_rwkv6_full_width.py --layers 1

Prints one JSON line.  Not collected by pytest (its name does not start
with ``test_``): at full width it holds several GB of host memory, about
6 GB at one layer and 3 GB more a layer on top.
"""
import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import models as ref_models
from repro.configs import get_config as ref_get_config
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.util import tree_leaves
from repro_torch.data import synthetic_token_batch
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import Transformer
from repro_torch.optim.adamw import global_norm


def _spread(leaves):
    return [float(np.asarray(a, np.float64).std()) for a in leaves]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)
    kw = dict(n_layers=args.layers, compute_dtype="float32")

    rmodel = ref_models.Transformer(
        dataclasses.replace(ref_get_config(args.arch), **kw))
    vocab = rmodel.cfg.vocab
    mb = {k: v[:1] for k, v in synthetic_token_batch(
        0, batch=8, seq=args.seq, vocab=vocab).items()}
    rparams = jax.jit(lambda k: rmodel.init(k)[0])(jax.random.PRNGKey(0))
    r_loss, r_grads = jax.jit(jax.value_and_grad(rmodel.train_loss))(
        rparams, {k: jnp.asarray(v) for k, v in mb.items()})
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(rparams)[0]]
    r_grads = [np.asarray(g) for g in jax.tree.leaves(r_grads)]
    r_norm = float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                               for g in r_grads)))
    ref_spread = _spread(jax.tree.leaves(rparams))

    pmodel = Transformer(dataclasses.replace(get_config(args.arch), **kw),
                         device="cpu")
    params = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), device="cpu")
    del rparams
    loss, grads = loss_and_grads(pmodel, params, mb)
    norm = float(global_norm(grads))
    leaf_err = {}
    for p, g, r in zip(paths, tree_leaves(grads), r_grads):
        leaf_err[p] = (float(np.abs(g.detach().numpy() - r).max())
                       / max(float(np.abs(r).max()), 1e-30))
    worst = max(leaf_err, key=leaf_err.get)
    zero = [p for p, g in zip(paths, tree_leaves(grads))
            if float(g.abs().max()) == 0.0]
    del params, grads, r_grads

    own = pmodel.init(0)
    ratios = [s / r for s, r in zip(_spread(tree_leaves(own)), ref_spread)
              if r > 0]
    _, own_grads = loss_and_grads(pmodel, own, mb)
    own_norm = float(global_norm(own_grads))

    print(json.dumps({
        "arch": args.arch, "layers": args.layers, "tokens": args.seq,
        "dtype": "float32", "torch": torch.__version__,
        "jax": jax.__version__,
        "loss": float(loss), "loss_ref": float(r_loss),
        "loss_rel_err": abs(float(loss) - float(r_loss)) / abs(float(r_loss)),
        "grad_norm": norm, "grad_norm_ref": r_norm,
        "grad_norm_rel_err": abs(norm - r_norm) / r_norm,
        "worst_leaf": worst, "worst_leaf_rel_err": leaf_err[worst],
        "zero_grad_leaves": zero,
        "init_spread_ratio": [min(ratios), max(ratios)],
        "own_init_grad_norm": own_norm}))


if __name__ == "__main__":
    main()
