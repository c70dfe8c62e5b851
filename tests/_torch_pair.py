"""Shared set-up of the port's parity tests: the same reduced config
built in both packages.  Weights follow the JAX package's parameter
schema (``param_defs``: keys, shapes, init rules), are drawn with numpy
from a seed (a jitted JAX init costs seconds of compile per config), and
reach the port through ``repro_torch.bridge``."""
import dataclasses as dc
import math

import numpy as np


def numpy_params(defs, seed=0):
    """A JAX parameter tree drawn with numpy by ``_init_one``'s rules."""
    import jax

    from repro.models.params import is_def

    rng = np.random.default_rng(seed)

    def draw(d):
        if d.init == "zeros":
            return np.zeros(d.shape, np.float32)
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        fan_in = d.shape[0] if len(d.shape) == 1 else int(
            np.prod(d.shape[:-1]))
        std = d.scale or {"embed": 1.0, "small": 0.02}.get(
            d.init, 1.0 / math.sqrt(max(fan_in, 1)))
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map(draw, defs, is_leaf=is_def)


def build_pair(arch, n_layers=2, **over):
    """(jcfg, jmodel, jparams, tcfg, tmodel, tparams) in fp32 on the
    CPU.  qkv biases (zero at init) are drawn so that they count."""
    from repro.configs.registry import smoke_config as jsmoke
    from repro.models import build_model as jbuild
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs.registry import smoke_config as tsmoke
    from repro_torch.models import build_model as tbuild

    kw = dict(n_layers=n_layers, compute_dtype="float32", **over)
    jcfg = dc.replace(jsmoke(arch), **kw)
    tcfg = dc.replace(tsmoke(arch), **kw)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = numpy_params(jm.param_defs())
    if jcfg.qkv_bias:
        rng = np.random.default_rng(1)
        for k in ("attn_bq", "attn_bk", "attn_bv"):
            jp["layers"][k] = (rng.standard_normal(jp["layers"][k].shape)
                               * 0.1).astype(np.float32)
    return jcfg, jm, jp, tcfg, tm, params_from_numpy(jp, device="cpu")


def prompts(vocab, n, length, seed=0):
    """Synthetic prompts from the port's copy of the data generator."""
    from repro_torch.data.synthetic import SyntheticLM
    return SyntheticLM(vocab, length, seed).batch(0, n)["tokens"]


# XLA's CPU backend at optimisation level 0: about half the compile time,
# the same fp32 arithmetic
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with ``FAST_XLA``."""
    import jax
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)


def jax_mesh():
    """A (1, 1) ("data", "model") mesh with Auto axes: the JAX gspmd
    step's microbatch path constrains shardings, which an Explicit-axis
    mesh (jax's default) refuses."""
    import jax
    auto = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=auto)


def train_both(arch, microbatch, n_steps, b, s, n_layers=2,
               plan_step=None):
    """The quickstart setting (``arch`` smoke, fp32, AdamW with
    warmup_cosine(3e-3, 2, 20), fp32 params) stepped in both packages
    from the same weights on the same synthetic batches; returns (JAX
    losses, port losses, JAX state, port state).  The JAX side runs its
    ``parallel.plan.make_train_step`` (``plan_step``, by default when
    n_steps > 1), from a state placed on the step's shardings so that it
    compiles once, or else the gspmd step that plan jits
    (``train_lib``), compiled here with ``FAST_XLA``."""
    import jax
    import jax.numpy as jnp

    from repro import train_lib
    from repro.optim import AdamW as JAdamW
    from repro.optim import warmup_cosine as jcos
    from repro.parallel import plan as jplan
    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.parallel import plan as tplan
    jcfg, jm, jp, tcfg, tm, tp = build_pair(arch, n_layers=n_layers)
    kw = dict(mode="gspmd", tp=1, fsdp=False, batch_axes=("data",),
              microbatch=microbatch)
    jopt = JAdamW(lr=jcos(3e-3, 2, 20), param_dtype="float32")
    topt = AdamW(lr=warmup_cosine(3e-3, 2, 20), param_dtype="float32")
    mesh = jax_mesh()
    jpl, tpl = jplan.ParallelPlan(**kw), tplan.ParallelPlan(**kw)
    jstate = jplan.init_state(jpl, jopt, jp, mesh)
    jstate = jax.device_put(jstate, train_lib.to_named(
        train_lib.state_pspecs(jm, jpl.gspmd_config(), mesh), mesh))
    tstate = tplan.init_state(tpl, topt, tp)
    tstep = tplan.make_train_step(tpl, tm, topt, device="cpu")
    batches = [batch_for_model(tcfg, "train", i, b, s)
               for i in range(n_steps)]
    jbatches = [{k: jnp.asarray(v) for k, v in x.items()} for x in batches]
    if not (n_steps > 1 if plan_step is None else plan_step):
        jstep = compiled(train_lib.make_train_step(
            jm, jopt, jpl.gspmd_config(), mesh), jstate, jbatches[0])
    else:
        jstep = jplan.make_train_step(jpl, jm, jopt, mesh,
                                      params_template=jp)
    jl, tl = [], []
    for batch, jbatch in zip(batches, jbatches):
        jstate, jmet = jstep(jstate, jbatch)
        tstate, tmet = tstep(tstate, batch)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
        assert set(tmet) == set(jmet)
    return jl, tl, jstate, tstate


def max_rel_close(got, want, name="", tol=1e-5):
    """|got - want| within ``tol`` of max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, name
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (name, err, scale)


def slow_decay(jp):
    """Mamba A_log set to log(0.05) in a JAX parameter tree (in place):
    a = -0.05 * dt per step, so a carried state survives a chunk (under
    the init rule's A_log = 1, a ~ -1.9 per step, none does and a
    dropped or stale carry hides)."""
    tree = jp["mamba"] if "mamba" in jp else jp
    tree["A_log"] = np.full_like(tree["A_log"], np.log(0.05))
    return jp
