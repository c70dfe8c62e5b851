"""The JAX side of tests/test_torch_ddp.py, run in its own interpreter
with 8 fake CPU devices (the test process keeps its one-device jax):

  python tests/_torch_ddp_jax.py PARAMS.npz OUT.npz

It calls the ``repro.core`` collectives inside ``shard_map`` on the
inputs of ``repro/testing/multidev.py``'s checks (never its ``main``)
and ``repro.core.ddp.make_ddp_train_step`` on the phi4-mini smoke
weights in PARAMS.npz (keeping the synced gradients the step hands its
optimizer), compiling each program at XLA's fast CPU
optimisation level, and writes every output to OUT.npz."""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses as dc  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def collective(f, x, mesh, spec):
    g = jax.jit(shard_map(lambda v: f(v[0]), mesh=mesh, in_specs=spec,
                          out_specs=P(), check_rep=False))
    return np.asarray(g.lower(x).compile(compiler_options=FAST)(x))


def unflat(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v)
    return tree


class Recording:
    """An optimizer that applies ``opt`` and keeps the synced gradients
    the step handed it in the new state (``"synced"``)."""

    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def apply(self, state, grads):
        return {**self.opt.apply(state, grads), "synced": grads}


def main(params_path, out_path):
    from repro.configs.registry import smoke_config
    from repro.core.compression import bf16_psum, fp8_psum, int8_psum
    from repro.core.ddp import make_ddp_train_step
    from repro.core.hfreduce import flat_allreduce, hfreduce, hfreduce_tree
    from repro.core.tree_allreduce import ring_allreduce, tree_allreduce
    from repro.data.synthetic import batch_for_model
    from repro.models import build_model
    from repro.optim import AdamW
    from repro.parallel.plan import ParallelPlan

    grid = jax.make_mesh((2, 4), ("pod", "data"))
    ring = jax.make_mesh((8,), ("n",))
    gspec, nspec = P(("pod", "data")), P("n")
    hf = dict(strong_axis="data", weak_axis="pod")
    out = {}
    x = jnp.arange(8 * 1000, dtype=jnp.float32).reshape(8, 1000) / 100.0
    out["hfreduce"] = collective(lambda v: hfreduce(v, **hf), x, grid, gspec)
    out["flat"] = collective(lambda v: flat_allreduce(v), x, grid, gspec)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((8, 257)),
                    jnp.float32)
    out["tree"] = collective(lambda v: tree_allreduce(v, "n"), x, ring, nspec)
    out["ring"] = collective(lambda v: ring_allreduce(v, "n"), x, ring, nspec)
    x = jnp.asarray(np.random.default_rng(1).standard_normal((8, 4096)),
                    jnp.float32)
    for name, fn in (("bf16", bf16_psum), ("int8", int8_psum),
                     ("fp8", fp8_psum)):
        out[name] = collective(lambda v, fn=fn: fn(v, "n"), x, ring, nspec)
    x = jnp.asarray(np.random.default_rng(2).standard_normal((8, 333)),
                    jnp.float32)
    out["hfreduce_tree"] = collective(lambda v: hfreduce_tree(v, **hf), x,
                                      grid, gspec)
    x = jnp.asarray(150.0 + np.random.default_rng(7).standard_normal(
        (8, 1024)), jnp.float32)
    out["fp8_fold"] = collective(
        lambda v: hfreduce(v, weak_psum=fp8_psum, prescale=1.0 / 8.0, **hf),
        x, grid, gspec)
    out["fp8_after"] = collective(
        lambda v: hfreduce(v, weak_psum=fp8_psum, **hf) / 8.0, x, grid,
        gspec)

    # check_ddp_step's setting on the given weights
    cfg = dc.replace(smoke_config("phi4-mini-3.8b"), n_layers=2,
                     compute_dtype="float32")
    model = build_model(cfg)
    opt = Recording(AdamW(lr=1e-2, param_dtype="float32"))
    params = unflat(dict(np.load(params_path)))
    state = opt.init(params)
    step, _ = make_ddp_train_step(lambda p, b: model.loss(p, b), opt, grid,
                                  ParallelPlan(mode="ddp"),
                                  params_template=params)
    batch = {k: jnp.asarray(v)
             for k, v in batch_for_model(cfg, "train", 0, 8, 32).items()}
    step = step.lower(state, batch).compile(compiler_options=FAST)
    new_state, metrics = step(state, batch)
    out["ddp_loss"] = np.asarray(metrics["loss"])
    for i, leaf in enumerate(jax.tree_util.tree_leaves(new_state["master"])):
        out[f"ddp_master_{i}"] = np.asarray(leaf)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(new_state["synced"])):
        out[f"ddp_synced_{i}"] = np.asarray(leaf)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
