"""The port's torch export (tgsr_tpu_torch/checkpoints/export_torch.py,
cli/export_torch.py) against tgsr_tpu's (checkpoints/export_torch.py,
cli/export_torch.py) on the CPU.

The same msgpack snapshots (flax trees made from seeded port weights, written
by the port's flax-compatible serializer) go through both CLIs: the x8 pair
with a text encoder and an Inception image encoder; the x16 pair whose netGH
carries the declared residual816 / upscale16x blocks; a weight-map netGH
(EVAL.WEIGHTMAP, a1..a3, no `a`); a SimpleCNN image encoder, which both skip.
Gates: the same file names, and in each file the same keys, dtypes, shapes
and values, bit for bit; the port's files load with strict=True into the
port's modules.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tgsr_tpu.cli import export_torch as jcli
from tgsr_tpu_torch.checkpoints import export_torch as tex
from tgsr_tpu_torch.checkpoints.from_jax import (cnn_encoder_variables, init_seeded,
                                                 netg_variables, netgh_variables,
                                                 seeded_cnn_encoder_state_dict, text_variables)
from tgsr_tpu_torch.checkpoints.io import save_variables
from tgsr_tpu_torch.cli import export_torch as tcli
from tgsr_tpu_torch.models.generator_hf import X8_MAP_SIZES
from tgsr_tpu_torch.models.image_encoder import make_image_encoder
from tgsr_tpu_torch.models.models16 import make_generators, unused_blocks
from tgsr_tpu_torch.models.text_encoder import TextEncoder
from tests.torch_parity import VOCAB, configs

torch.set_num_threads(1)
NEF = 32  # the text encoder's width, EMBEDDING_DIM of the small geometry


def _yaml(branch_num: int, weightmap: bool = False) -> str:
    return (f"CONFIG_NAME: 'narrow'\nTREE:\n    BRANCH_NUM: {branch_num}\n    BASE_SIZE: 8\n"
            "GAN:\n    GF_DIM: 8\n    CONDITION_DIM: 10\n"
            f"TEXT:\n    EMBEDDING_DIM: {NEF}\n    WORDS_NUM: 6\n"
            + ("EVAL:\n    WEIGHTMAP: True\n" if weightmap else ""))


def _trees(branch_num: int, seed: int):
    """(netg tree, netgh tree, the port's text state dict, cfg) from seeded
    port weights."""
    _, tcfg = configs(branch_num=branch_num)
    text_sd, netg_sd, netgh_sd, _ = init_seeded(tcfg, VOCAB, torch.Generator().manual_seed(seed))
    return netg_variables(netg_sd), netgh_variables(netgh_sd, 0.3), text_sd, tcfg


def _with_unused(netgh, rng):
    """The x16 netGH tree with residual816 / upscale16x (copies of residual48
    and upscale8x, moved), as a fix_bugs=True tree carries them."""
    for new, old in (("residual816", "residual48"), ("upscale16x", "upscale8x")):
        for coll in ("params", "batch_stats"):
            netgh[coll][new] = _moved(netgh[coll][old], rng)
    return netgh


def _moved(tree, rng):
    if isinstance(tree, dict):
        return {k: _moved(v, rng) for k, v in tree.items()}
    return (tree * rng.uniform(0.5, 1.5, np.shape(tree))).astype(np.float32)


def _both(tmp, argv):
    """Both CLIs on argv; returns (JAX's out dir, the port's)."""
    outs = []
    for tag, main in (("jax", jcli.main), ("port", tcli.main)):
        out = os.path.join(tmp, tag)
        main(argv + ["--out", out])
        outs.append(out)
    return outs


def _assert_same_files(jax_dir, port_dir):
    names = sorted(os.listdir(jax_dir))
    assert names and names == sorted(os.listdir(port_dir))
    loaded = {}
    for name in names:
        j = torch.load(os.path.join(jax_dir, name), weights_only=True)
        t = torch.load(os.path.join(port_dir, name), weights_only=True)
        assert sorted(j) == sorted(t), name
        for k in j:
            assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape, (name, k)
            assert torch.equal(j[k], t[k]), (name, k)
        loaded[name] = t
    return loaded


@pytest.fixture(scope="module")
def image_encoders():
    gen = torch.Generator().manual_seed(3)
    return {simple: cnn_encoder_variables(seeded_cnn_encoder_state_dict(simple, NEF, gen))
            for simple in (False, True)}


def test_x8_pair_text_and_inception_encoder(tmp_path, image_encoders):
    netg, netgh, text_sd, tcfg = _trees(4, seed=0)
    snaps = tmp_path / "Model"
    save_variables(str(snaps / "netG_it500.msgpack"), netg)
    save_variables(str(snaps / "netGH_it500.msgpack"), netgh)
    save_variables(str(snaps / "text_encoder5.msgpack"), text_variables(text_sd))
    save_variables(str(snaps / "image_encoder5.msgpack"), image_encoders[False])
    (tmp_path / "s8.yml").write_text(_yaml(4))
    jax_dir, port_dir = _both(str(tmp_path), [
        "--cfg", str(tmp_path / "s8.yml"), "--netg", str(snaps / "netG_it500.msgpack"),
        "--text_encoder", str(snaps / "text_encoder5.msgpack")])
    files = _assert_same_files(jax_dir, port_dir)
    assert sorted(files) == ["image_encoder5.pth", "netGH_it500.pth", "netG_it500.pth",
                             "text_encoder5.pth"]
    assert "a" not in files["netGH_it500.pth"]  # not a registered parameter of the reference
    g, gh = make_generators(tcfg)
    g.load_state_dict(files["netG_it500.pth"], strict=True)
    gh.load_state_dict(files["netGH_it500.pth"], strict=True)
    TextEncoder(VOCAB, 300, NEF).load_state_dict(files["text_encoder5.pth"], strict=True)
    make_image_encoder(False, NEF).load_state_dict(files["image_encoder5.pth"], strict=True)


def test_x16_pair_with_the_unused_blocks(tmp_path):
    """netG carries every alias key set of the tied stage and head; netGH
    exports residual816 / upscale16x because the tree has them."""
    netg, netgh, _, tcfg = _trees(5, seed=1)
    netgh = _with_unused(netgh, np.random.default_rng(1))
    save_variables(str(tmp_path / "netG_it7.msgpack"), netg)
    save_variables(str(tmp_path / "netGH_it7.msgpack"), netgh)
    (tmp_path / "s16.yml").write_text(_yaml(5))
    jax_dir, port_dir = _both(str(tmp_path), ["--cfg", str(tmp_path / "s16.yml"),
                                              "--netg", str(tmp_path / "netG_it7.msgpack")])
    files = _assert_same_files(jax_dir, port_dir)
    netg_sd, netgh_sd = files["netG_it7.pth"], files["netGH_it7.pth"]
    assert {k.split(".")[0] for k in netg_sd} >= {"h_net3", "h_net4", "img_net4"}
    assert unused_blocks(netgh_sd) == ("residual816", "upscale16x")
    g, gh = make_generators(tcfg, unused_blocks(netgh_sd))
    g.load_state_dict(netg_sd, strict=True)
    gh.load_state_dict(netgh_sd, strict=True)


def test_weightmap_netgh(tmp_path):
    """A weight-map netGH (a1..a3 at the x8 maps' 64 / 128 / 256 px, no `a`)
    exports its maps, as JAX's does, and the file loads with strict=True
    into the port's weight-map netGH (EVAL.WEIGHTMAP)."""
    netg, netgh, _, tcfg = _trees(4, seed=2)
    rng = np.random.default_rng(2)
    del netgh["params"]["a"]
    for i, size in enumerate(X8_MAP_SIZES, 1):
        netgh["params"][f"a{i}"] = rng.uniform(0, 1, (size, size)).astype(np.float32)
    save_variables(str(tmp_path / "netG_wm.msgpack"), netg)
    save_variables(str(tmp_path / "netGH_wm.msgpack"), netgh)
    (tmp_path / "wm.yml").write_text(_yaml(4, weightmap=True))
    jax_dir, port_dir = _both(str(tmp_path), ["--cfg", str(tmp_path / "wm.yml"),
                                              "--netg", str(tmp_path / "netG_wm.msgpack")])
    files = _assert_same_files(jax_dir, port_dir)
    assert {"a1", "a2", "a3"} <= set(files["netGH_wm.pth"])
    wcfg = dataclasses.replace(tcfg, EVAL=dataclasses.replace(tcfg.EVAL, WEIGHTMAP=True))
    gh = make_generators(wcfg)[1]
    gh.load_state_dict(files["netGH_wm.pth"], strict=True)
    assert torch.equal(gh.a2, torch.from_numpy(netgh["params"]["a2"]))


def test_simple_cnn_encoder_is_skipped(tmp_path, image_encoders, capsys):
    """Both skip a SimpleCNN image encoder with the same message and export
    the text encoder; the port's function refuses the tree with the reason."""
    _, _, text_sd, _ = _trees(4, seed=0)
    save_variables(str(tmp_path / "text_encoder2.msgpack"), text_variables(text_sd))
    save_variables(str(tmp_path / "image_encoder2.msgpack"), image_encoders[True])
    capsys.readouterr()
    jax_dir, port_dir = _both(str(tmp_path), ["--text_encoder",
                                              str(tmp_path / "text_encoder2.msgpack")])
    out = capsys.readouterr().out
    assert out.count("skipping") == 2 and out.count("SimpleCNNEncoder snapshot") == 2
    assert sorted(_assert_same_files(jax_dir, port_dir)) == ["text_encoder2.pth"]
    with pytest.raises(ValueError, match="SimpleCNNEncoder"):
        tex.export_cnn_encoder(image_encoders[True])


def test_cli_argument_checks(tmp_path):
    """JAX's refusals: no snapshot named; --netg without --cfg."""
    with pytest.raises(SystemExit, match="--netg and/or --text_encoder"):
        tcli.main(["--out", str(tmp_path)])
    with pytest.raises(SystemExit, match="needs --cfg"):
        tcli.main(["--netg", "netG_it1.msgpack", "--out", str(tmp_path)])
