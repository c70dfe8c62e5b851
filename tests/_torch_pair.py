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
