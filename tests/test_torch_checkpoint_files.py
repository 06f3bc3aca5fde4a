"""The port's checkpoint files and their helpers against tgsr_tpu on the CPU:
`paired_path`, `bucket_shape`, `Vocab`, the config dict of a bundle, and
`SRPipeline.from_reference_checkpoints` on a `.pth` pair written by
tgsr_tpu/checkpoints/export_torch.py and on a flax `.msgpack` pair.

Outputs of both packages on the same files: the pipeline gate of
tests/test_torch_pipeline.py (rtol = 1e-3, atol = 2e-4 on the float32 SR:
the same weights, float reassociation only).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tgsr_tpu import config as jconfig
from tgsr_tpu.checkpoints import export_torch
from tgsr_tpu.checkpoints.convert_torch import paired_path as jax_paired_path
from tgsr_tpu.checkpoints.io import save_variables
from tgsr_tpu.data.tokenizer import Vocab as JVocab
from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu.ops.image import bucket_shape as jax_bucket_shape
from tgsr_tpu_torch.checkpoints.reference import load_generator_pair, paired_path
from tgsr_tpu_torch.config import check_trained, config_from_dict, config_to_dict, face_s8_config
from tgsr_tpu_torch.data.tokenizer import Vocab
from tgsr_tpu_torch.engine.inference import SRPipeline
from tgsr_tpu_torch.ops.image import bucket_shape
from tests.torch_parity import SMALL, VOCAB, configs, inputs, jax_trees

torch.set_num_threads(1)
PYR = dict(rtol=1e-3, atol=2e-4)
T = SMALL["WORDS_NUM"]


def test_bucket_shape_matches_jax():
    for h in (1, 5, 7, 8, 9, 31, 32, 33, 64, 65, 100):
        for w in (1, 3, 8, 17, 40, 64, 129):
            for scale in (1, 2, 8):
                for bucket in (1, 4, 8, 16, 64):
                    assert bucket_shape(h, w, scale, bucket) == jax_bucket_shape(
                        h, w, scale, bucket), (h, w, scale, bucket)
    assert bucket_shape(33, 65, 8) == jax_bucket_shape(33, 65, 8) == (64, 128)


@pytest.mark.parametrize("path", [
    "netG_epoch_7.pth", "ckpt/netG_epoch_7.pth", "/abs/netG_dir/netG_it100.msgpack",
    "runs/netG/netG_epoch_7.pth", "netGnetG.pth", "no_pair.pth", "netG_dir/", "",
    "/a/netG_x/b/text_encoder100.pth",
])
def test_paired_path_matches_jax(path):
    for a, b in (("netG", "netGH"), ("text_encoder", "image_encoder")):
        assert paired_path(path, a, b) == jax_paired_path(path, a, b)
    # a directory whose name holds netG is not rewritten
    if os.sep in path:
        assert paired_path(path, "netG", "netGH").startswith(os.path.dirname(path))


def test_vocab_matches_jax():
    ixtoword = {0: "<end>", 1: "smiling", 2: "woman", 3: "hair"}
    wordtoix = {w: i for i, w in ixtoword.items()}
    port, ref = Vocab(ixtoword, wordtoix), JVocab(ixtoword, wordtoix)
    toks = ["woman", "with", "hair", "smiling"]
    assert port.encode_tokens(toks) == ref.encode_tokens(toks) == [2, 3, 1]
    assert port.decode([1, 9, 3, 0]) == ref.decode([1, 9, 3, 0])
    assert port.n_words == ref.n_words == 4


def _jax_face_s8():
    j = jconfig.Config()
    return dataclasses.replace(
        j, TREE=dataclasses.replace(j.TREE, BRANCH_NUM=4, BASE_SIZE=32),
        GAN=dataclasses.replace(j.GAN, GF_DIM=32))


def test_config_dict_round_trips_with_jax():
    """JAX's full-schema dict builds the port's config; the port's dict
    builds the same geometry in JAX."""
    cfg = config_from_dict(jconfig.config_to_dict(_jax_face_s8()))
    assert cfg == face_s8_config()
    assert config_from_dict(config_to_dict(cfg)) == cfg
    back = jconfig.config_from_dict(config_to_dict(cfg))
    assert (back.TREE, back.GAN.GF_DIM, back.GAN.R_NUM, back.GAN.CONDITION_DIM) == (
        _jax_face_s8().TREE, 32, 2, 100)
    assert (back.TEXT.EMBEDDING_DIM, back.TEXT.WORDS_NUM, back.RNN_TYPE) == (256, 18, "LSTM")
    assert (back.EVAL.INPUT_NETGH, back.EVAL.WEIGHTMAP, back.EVAL.STAGE1) == ("lr", False, False)


@pytest.mark.parametrize("section, key, value", [
    ("TREE", "BRANCH_NUM", 3), ("TREE", "BRANCH_NUM", 6), (None, "RNN_TYPE", "RNN_TANH"),
])
def test_config_refuses_what_the_port_does_not_serve(section, key, value):
    d = jconfig.config_to_dict(_jax_face_s8())
    (d[section] if section else d)[key] = value
    with pytest.raises(NotImplementedError, match=key):
        config_from_dict(d)


@pytest.mark.parametrize("key, value", [
    ("INPUT_NETGH", "lrblur"), ("INPUT_NETGH", "lr-lrblur"),
    ("WEIGHTMAP", True), ("STAGE1", True),
])
def test_config_round_trips_the_eval_switches(key, value):
    """The EVAL switches JAX's SRPipeline reads are served: JAX's dict builds
    the port's config with the switch set, and the port's dict gives JAX the
    same config back. Training takes the blur inputs and weight maps, not
    STAGE1 (JAX's GANTrainer never builds the stage-1 generator)."""
    d = jconfig.config_to_dict(_jax_face_s8())
    d["EVAL"][key] = value
    cfg = config_from_dict(d)
    assert getattr(cfg.EVAL, key) == value
    assert jconfig.config_from_dict(config_to_dict(cfg)) == jconfig.config_from_dict(d)
    if key == "STAGE1":
        with pytest.raises(NotImplementedError, match="STAGE1"):
            check_trained(cfg)
    else:
        assert check_trained(cfg) is cfg


def test_config_refuses_unknown_keys_and_types():
    d = jconfig.config_to_dict(_jax_face_s8())
    with pytest.raises(KeyError):
        config_from_dict({**d, "NOT_A_KEY": 1})
    with pytest.raises(KeyError):
        config_from_dict({**d, "EVAL": {**d["EVAL"], "NOT_A_KEY": 1}})
    with pytest.raises(ValueError):
        config_from_dict({**d, "GAN": {**d["GAN"], "GF_DIM": "32"}})
    with pytest.raises(ValueError):
        config_from_dict({**d, "TREE": {**d["TREE"], "BASE_SIZE": True}})


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    return jcfg, tcfg, jax_trees(jcfg)


def _pth_files(tmp_path, trees):
    text, netg, netgh = trees
    paths = [str(tmp_path / "text_encoder100.pth"), str(tmp_path / "netG_epoch_7.pth"),
             str(tmp_path / "netGH_epoch_7.pth")]
    for path, sd in zip(paths, (export_torch.export_text_encoder(text),
                                export_torch.export_netg_low(netg),
                                export_torch.export_netgh_weight(netgh))):
        export_torch.save_torch(sd, path)
    return paths


def test_reference_pth_pair_matches_jax(setup, tmp_path):
    """A .pth pair and text encoder written by tgsr_tpu's exporter, loaded
    by both packages' from_reference_checkpoints (netGH by name, a = 0.5)."""
    jcfg, tcfg, trees = setup
    text, netg, _ = _pth_files(tmp_path, trees)
    jpipe = JSRPipeline.from_reference_checkpoints(jcfg, VOCAB, netg, text_encoder_path=text)
    tpipe = SRPipeline.from_reference_checkpoints(tcfg, VOCAB, netg, text_encoder_path=text,
                                                  device="cpu")
    assert tpipe.a == 0.5 and float(tpipe.netgh.a) == 0.5
    lr, cap, lens = inputs(2, SMALL["BASE_SIZE"], T, [T, 2], seed=11)
    np.testing.assert_allclose(tpipe(lr, cap, lens)["sr"].numpy(),
                               np.asarray(jpipe(lr, cap, lens)["sr"]), **PYR)


def test_msgpack_pair_matches_jax(setup, tmp_path):
    """cli.train_gan's flax snapshots (netG_it* / netGH_it*, the trained a
    carried) and a flax text encoder tree, read through msgpack_io."""
    jcfg, tcfg, (text, netg, netgh) = setup
    for name, tree in (("text.msgpack", text), ("netG_it5.msgpack", netg),
                       ("netGH_it5.msgpack", netgh)):
        save_variables(str(tmp_path / name), tree)
    args = (VOCAB, str(tmp_path / "netG_it5.msgpack"))
    kw = dict(text_encoder_path=str(tmp_path / "text.msgpack"))
    jpipe = JSRPipeline.from_reference_checkpoints(jcfg, *args, **kw)
    tpipe = SRPipeline.from_reference_checkpoints(tcfg, *args, device="cpu", **kw)
    assert tpipe.a == pytest.approx(0.3)
    lr, cap, lens = inputs(2, SMALL["BASE_SIZE"], T, [3, T], seed=12)
    np.testing.assert_allclose(tpipe(lr, cap, lens)["sr"].numpy(),
                               np.asarray(jpipe(lr, cap, lens)["sr"]), **PYR)


def test_pair_given_apart_and_seeded_text(setup, tmp_path):
    """netgh_path given explicitly; without a text encoder the weights are
    seeded from text_seed (the same seed the same weights, another seed
    others)."""
    _, tcfg, trees = setup
    _, netg, netgh = _pth_files(tmp_path, trees)
    moved = str(tmp_path / "elsewhere.pth")
    os.rename(netgh, moved)
    sds = load_generator_pair(tcfg, netg, moved)
    assert sds[2] == 0.5 and "a" not in sds[1]
    with pytest.raises(FileNotFoundError):
        load_generator_pair(tcfg, netg)
    pipes = [SRPipeline.from_reference_checkpoints(tcfg, VOCAB, netg, moved, text_seed=seed,
                                                   device="cpu") for seed in (100, 100, 7)]
    emb = [p.text_encoder.encoder.weight for p in pipes]
    assert torch.equal(emb[0], emb[1]) and not torch.equal(emb[0], emb[2])
