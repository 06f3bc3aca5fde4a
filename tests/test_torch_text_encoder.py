"""TextEncoder of tgsr_tpu_torch against tgsr_tpu, f32 on the CPU.

Caption lengths 0 (an empty caption), 3 and T. Gate rtol = atol = 1e-5:
18 LSTM steps of 128-wide float32 products summed in another order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.checkpoints.io import load_variables
from tgsr_tpu.models.text_encoder import TextEncoder as JTextEncoder
from tgsr_tpu_torch.checkpoints.from_jax import text_state_dict
from tgsr_tpu_torch.models.text_encoder import TextEncoder

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
T, VOCAB = 18, 41
NET_E = os.path.join(os.path.dirname(__file__), os.pardir, "tgsr_tpu",
                     "checkpoints", "face_net_e_s8.msgpack")


def _captions(lens, seed=0):
    rng = np.random.default_rng(seed)
    cap = rng.integers(1, VOCAB, (len(lens), T)).astype(np.int32)
    for i, n in enumerate(lens):
        cap[i, n:] = 0
    return cap, np.asarray(lens, np.int32)


def _compare(variables, nhidden, cap, lens):
    jm = JTextEncoder(vocab_size=VOCAB, nhidden=nhidden, rnn_type="LSTM")
    words_r, sent_r = jm.apply(variables, jnp.asarray(cap), jnp.asarray(lens))
    m = TextEncoder(VOCAB, 300, nhidden).eval()
    m.load_state_dict(text_state_dict(variables), strict=True)
    with torch.no_grad():
        words, sent = m(torch.from_numpy(cap).long(), torch.from_numpy(lens).long())
    np.testing.assert_allclose(words.numpy(), np.asarray(words_r), **TOL)
    np.testing.assert_allclose(sent.numpy(), np.asarray(sent_r), **TOL)
    return words.numpy(), sent.numpy()


@pytest.mark.parametrize("nhidden", [256, 32])
def test_seeded_matches_jax(nhidden):
    cap, lens = _captions([0, 3, T])
    variables = JTextEncoder(vocab_size=VOCAB, nhidden=nhidden).init(
        jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32),
        jnp.ones((1,), jnp.int32))
    words, sent = _compare(jax.tree.map(np.asarray, variables), nhidden, cap, lens)
    # outputs are zero past len; an empty caption has zero words and sentence
    assert not words[1, 3:].any() and not words[0].any() and not sent[0].any()


@pytest.mark.skipif(not os.path.exists(NET_E), reason="shipped NET_E absent")
def test_shipped_net_e_matches_jax():
    """The trained face NET_E shipped with tgsr_tpu, carried across."""
    cap, lens = _captions([0, 3, T, 11], seed=1)
    _compare(load_variables(NET_E), 256, cap, lens)
