"""The port's ``DecoderLM.forward`` against the JAX package's on the CPU:
fresh prefill with padding, chunked prefill, T = 1 decode and a
late-arriving slot (mirrors tests/test_seq_state.py::
test_chunked_prefill_matches_monolithic and
::test_late_arriving_slot_positions).  Logits agree within 1e-5 in
fp32 and greedy tokens are identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_pair import build_pair, prompts  # noqa: E402

PROMPT, GEN, TOL = 18, 4, 1e-5


class _Both:
    """One model in both packages, stepped in lockstep."""

    def __init__(self, arch):
        (_, self.jm, self.jp, self.cfg, self.tm,
         self.tp) = build_pair(arch)

    def states(self, b, cap):
        return (self.jm.init_seq_state(self.jp, cap, batch_size=b,
                                       dtype="float32"),
                self.tm.init_seq_state(self.tp, cap, batch_size=b,
                                       dtype="float32"))

    def step(self, states, toks, pos, fresh=False):
        js, ts = states
        toks, pos = np.asarray(toks, np.int32), np.asarray(pos, np.int32)
        with jax.disable_jit():
            js, jl = self.jm.forward(self.jp, js, jnp.asarray(toks),
                                     jnp.asarray(pos), fresh=fresh)
        ts, tl = self.tm.forward(self.tp, ts, torch.from_numpy(toks),
                                 torch.from_numpy(pos), fresh=fresh)
        # a slot whose chunk is all padding yields a row the contract
        # leaves undefined (the JAX reference averages, the port zeros)
        live = (pos >= 0).any(axis=1)
        jl, tl = np.asarray(jl), tl.numpy()
        np.testing.assert_allclose(tl[live], jl[live], atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(tl[live].argmax(-1),
                                      jl[live].argmax(-1))
        return (js, ts), jl.argmax(-1).astype(np.int32)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "codeqwen1.5-7b",
                                  "nemotron-4-15b"])
def test_forward_matches_jax(arch):
    m = _Both(arch)
    toks = prompts(m.cfg.vocab_size, 2, PROMPT)
    pos = np.broadcast_to(np.arange(PROMPT), (2, PROMPT)).astype(np.int32)
    pos[1, -1] = -1                             # slot 1: a padding token
    lens = (pos >= 0).sum(1)

    # whole prompt as one fresh chunk, then greedy T = 1 decode
    st, nxt = m.step(m.states(2, PROMPT + GEN), toks, pos, fresh=True)
    first = nxt
    for i in range(GEN - 1):
        st, nxt = m.step(st, nxt[:, None], (lens + i)[:, None])

    # the same prompt in chunks of one token (the cache path, not the
    # fresh one) reaches the same first token; slot 1's last chunk is
    # all padding and keeps its token from the chunk before
    st2 = m.states(2, PROMPT + GEN)
    firsts = []
    for t in range(PROMPT):
        st2, nxt2 = m.step(st2, toks[:, t:t + 1], pos[:, t:t + 1])
        firsts.append(nxt2)
    np.testing.assert_array_equal(
        [firsts[n - 1][i] for i, n in enumerate(lens)], first)

    # late arrival: slot 0 decodes while slot 1 replays its prompt token
    # by token at its own positions, beside it in the same chunk
    st3, nxt3 = m.step(m.states(2, PROMPT + GEN), toks * [[1], [0]],
                       np.where([[True], [False]], pos, -1), fresh=True)
    for i in range(GEN):
        st3, nxt3 = m.step(st3, [[nxt3[0]], [toks[1, i]]],
                           [[PROMPT + i], [i]])
