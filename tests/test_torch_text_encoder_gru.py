"""The GRU TextEncoder of tgsr_tpu_torch against tgsr_tpu's
(TextEncoder(rnn_type="GRU"), `_masked_gru`), f32 on the CPU.

Caption lengths 0 (an empty caption), 1 and T in one batch. Gates: outputs
and gradients at rtol = atol = 1e-4 (ROADMAP's block gate); weights carried
both ways by `from_jax` and through a reference `.pth` by both packages'
loaders; the export of a GRU snapshot bit for bit JAX's; the config checks
taking 'GRU' and refusing another recurrence by name.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.checkpoints.convert_torch import convert_text_encoder, load_torch_state_dict
from tgsr_tpu.checkpoints.export_torch import export_text_encoder
from tgsr_tpu.models.text_encoder import TextEncoder as JTextEncoder
from tgsr_tpu_torch import config as tconfig
from tgsr_tpu_torch.checkpoints.from_jax import (seeded_text_state_dict, text_state_dict,
                                                 text_variables)
from tgsr_tpu_torch.checkpoints.reference import load_text_encoder, rnn_type_of
from tgsr_tpu_torch.checkpoints.shipped import resolve_net_e, shipped_net_e
from tgsr_tpu_torch.models.text_encoder import TextEncoder

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
T, VOCAB = 18, 41


def _captions(lens, seed=0):
    rng = np.random.default_rng(seed)
    cap = rng.integers(1, VOCAB, (len(lens), T)).astype(np.int32)
    for i, n in enumerate(lens):
        cap[i, n:] = 0
    return cap, np.asarray(lens, np.int32)


def _jax_tree(nhidden, seed=0):
    """A JAX GRU init with every bias moved off its U(-1/sqrt(H), .) draw by
    a different amount for b_ih and b_hh, so that folding b_hn into the
    input projection would show."""
    v = JTextEncoder(vocab_size=VOCAB, nhidden=nhidden, rnn_type="GRU").init(
        jax.random.PRNGKey(seed), jnp.zeros((1, T), jnp.int32), jnp.ones((1,), jnp.int32))
    params = {k: np.asarray(x) for k, x in v["params"].items()}
    rng = np.random.default_rng(seed)
    for k in [k for k in params if k.startswith("b_")]:
        params[k] = (params[k] + rng.normal(0, 0.5, params[k].shape)).astype(np.float32)
    return {"params": params}


def _port(variables, nhidden):
    m = TextEncoder(VOCAB, 300, nhidden, rnn_type="GRU").eval()
    m.load_state_dict(text_state_dict(variables), strict=True)
    return m


@pytest.mark.parametrize("nhidden", [256, 32])
def test_gru_matches_jax(nhidden):
    cap, lens = _captions([0, 1, T, 7])
    variables = _jax_tree(nhidden)
    words_r, sent_r = JTextEncoder(vocab_size=VOCAB, nhidden=nhidden, rnn_type="GRU").apply(
        variables, jnp.asarray(cap), jnp.asarray(lens))
    with torch.no_grad():
        words, sent = _port(variables, nhidden)(torch.from_numpy(cap).long(),
                                                torch.from_numpy(lens).long())
    np.testing.assert_allclose(words.numpy(), np.asarray(words_r), **TOL)
    np.testing.assert_allclose(sent.numpy(), np.asarray(sent_r), **TOL)
    # zero past len; an empty caption has zero words and a zero sentence
    assert not words[0].any() and not sent[0].any() and not words[1, 1:].any()
    assert words[2].abs().min(dim=-1).values.gt(0).all()


def test_gru_gradients_match_jax():
    """d(loss)/d(every weight) of one loss over words and sentence against
    jax.grad of the same loss on the same tree."""
    nhidden = 32
    cap, lens = _captions([0, 1, T, 5], seed=1)
    variables = _jax_tree(nhidden, seed=1)
    rng = np.random.default_rng(2)
    rw = rng.normal(size=(4, T, nhidden)).astype(np.float32)
    rs = rng.normal(size=(4, nhidden)).astype(np.float32)
    jm = JTextEncoder(vocab_size=VOCAB, nhidden=nhidden, rnn_type="GRU")

    def jloss(params):
        w, s = jm.apply({"params": params}, jnp.asarray(cap), jnp.asarray(lens))
        return jnp.sum(w * rw) + jnp.sum(jnp.tanh(s) * rs)

    jgrads = jax.grad(jloss)(jax.tree.map(jnp.asarray, variables["params"]))
    m = _port(variables, nhidden)
    w, s = m(torch.from_numpy(cap).long(), torch.from_numpy(lens).long())
    (torch.sum(w * torch.from_numpy(rw)) + torch.sum(torch.tanh(s) * torch.from_numpy(rs))
     ).backward()
    grads = text_variables({k: p.grad for k, p in m.named_parameters()})["params"]
    assert sorted(grads) == sorted(jgrads)
    for k in grads:
        np.testing.assert_allclose(grads[k], np.asarray(jgrads[k]), err_msg=k, **TOL)


def test_gru_pth_through_both_loaders(tmp_path):
    """A GRU `.pth` (seeded port weights) read by JAX's convert_text_encoder(sd,
    'GRU') and by the port's loader gives the same encoder; the port refuses
    it for an LSTM config, naming both recurrences, and refuses an LSTM file
    for a GRU config."""
    cfg = dataclasses.replace(tconfig.face_s8_config(), RNN_TYPE="GRU")
    sd = seeded_text_state_dict(cfg, VOCAB, torch.Generator().manual_seed(4))
    assert sd["rnn.weight_ih_l0"].shape == (384, 300) and rnn_type_of(sd) == "GRU"
    path = str(tmp_path / "text_encoder7.pth")
    torch.save(sd, path)
    jv = convert_text_encoder(load_torch_state_dict(path), "GRU")
    cap, lens = _captions([T, 0, 3], seed=3)
    words_r, sent_r = JTextEncoder(vocab_size=VOCAB, nhidden=256, rnn_type="GRU").apply(
        jv, jnp.asarray(cap), jnp.asarray(lens))
    m = TextEncoder(VOCAB, 300, 256, rnn_type="GRU").eval()
    m.load_state_dict(load_text_encoder(path, "GRU"), strict=True)
    with torch.no_grad():
        words, sent = m(torch.from_numpy(cap).long(), torch.from_numpy(lens).long())
    np.testing.assert_allclose(words.numpy(), np.asarray(words_r), **TOL)
    np.testing.assert_allclose(sent.numpy(), np.asarray(sent_r), **TOL)
    with pytest.raises(ValueError, match="holds a GRU text encoder.*'LSTM'"):
        load_text_encoder(path, "LSTM")
    lstm = str(tmp_path / "lstm.pth")
    torch.save(seeded_text_state_dict(tconfig.face_s8_config(), VOCAB,
                                      torch.Generator().manual_seed(5)), lstm)
    with pytest.raises(ValueError, match="holds a LSTM text encoder.*'GRU'"):
        load_text_encoder(lstm, "GRU")


def test_gru_export_matches_jax():
    """The way back to a reference `.pth`: the port's text_state_dict of a
    GRU tree equals JAX's export_text_encoder bit for bit, and the tree
    round-trips through text_variables."""
    variables = _jax_tree(64, seed=5)
    port = text_state_dict(variables)
    jax_sd = export_text_encoder(variables)
    assert sorted(port) == sorted(jax_sd)
    for k in port:
        assert np.array_equal(port[k].numpy(), np.asarray(jax_sd[k], np.float32)), k
    back = text_variables(port)["params"]
    for k, v in variables["params"].items():
        assert np.array_equal(back[k], v), k


@pytest.mark.parametrize("check", ["check_served", "check_trained", "check_damsm"])
def test_checks_take_gru_and_refuse_another(check):
    fn = getattr(tconfig, check)
    cfg = tconfig.face_s8_config()
    assert fn(dataclasses.replace(cfg, RNN_TYPE="GRU")).RNN_TYPE == "GRU"
    with pytest.raises(NotImplementedError, match="RNN_TYPE = 'RNN'"):
        fn(dataclasses.replace(cfg, RNN_TYPE="RNN"))


def test_encoder_refuses_another_recurrence():
    """As JAX's TextEncoder: NotImplementedError naming the value."""
    with pytest.raises(NotImplementedError, match="RNN_TANH"):
        TextEncoder(VOCAB, 300, 32, rnn_type="RNN_TANH")


def test_shipped_net_e_is_not_handed_to_a_gru_config():
    """The shipped face NET_E is an LSTM: a GRU config at its vocabulary
    falls through to the seeded init rather than to a file it cannot load."""
    assert shipped_net_e(VOCAB) is not None and shipped_net_e(VOCAB, "GRU") is None
    cfg = dataclasses.replace(tconfig.face_s8_config(), RNN_TYPE="GRU")
    assert resolve_net_e(cfg, "", VOCAB) == (None, "seeded init (no NET_E source available)")


def test_gru_snapshot_exports_as_jaxs_cli(tmp_path):
    """`cli.export_torch --text_encoder` of a GRU snapshot (a flax msgpack
    written by the port's serializer) gives JAX's CLI's file bit for bit,
    and the file loads strict into the port's GRU encoder."""
    from tgsr_tpu.cli import export_torch as jcli
    from tgsr_tpu_torch.checkpoints.io import save_variables
    from tgsr_tpu_torch.cli import export_torch as tcli

    snap = str(tmp_path / "text_encoder3.msgpack")
    save_variables(snap, _jax_tree(32, seed=6))
    files = {}
    for tag, main in (("jax", jcli.main), ("port", tcli.main)):
        main(["--text_encoder", snap, "--out", str(tmp_path / tag)])
        files[tag] = torch.load(str(tmp_path / tag / "text_encoder3.pth"), weights_only=True)
    assert sorted(files["jax"]) == sorted(files["port"])
    for k, v in files["jax"].items():
        assert v.dtype == files["port"][k].dtype and torch.equal(v, files["port"][k]), k
    TextEncoder(VOCAB, 300, 32, rnn_type="GRU").load_state_dict(files["port"], strict=True)
