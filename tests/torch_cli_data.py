"""Shared set-up of the eval and calibration CLI tests: a face example set in
the reference's layout (testset.txt in CelebA's attribute format, PNG images
under Img/changetxt_im1/), a narrow x8 YAML (BASE_SIZE 16, GF_DIM 8) or a
narrow S16 YAML (BRANCH_NUM 5, BASE_SIZE 8, GF_DIM 8), and seeded .pth
weights carried across from one tgsr_tpu init (x16: in the reference's
models16 layout, aliases and all), with the text encoder as a .pth too, so
that both packages load the same weights."""

import os
import shutil

import numpy as np
import torch

from tgsr_tpu_torch.checkpoints.from_jax import state_dicts_from_jax
from tgsr_tpu_torch.data.codec import encode_png
from tgsr_tpu_torch.data.tokenizer import build_dictionary
from tests.torch_parity import configs, jax_trees, jax_trees16

# CelebA's 40 attributes, in the order of list_attr_celeba.txt
ATTRS = ("5_o_Clock_Shadow Arched_Eyebrows Attractive Bags_Under_Eyes Bald Bangs Big_Lips "
         "Big_Nose Black_Hair Blond_Hair Blurry Brown_Hair Bushy_Eyebrows Chubby Double_Chin "
         "Eyeglasses Goatee Gray_Hair Heavy_Makeup High_Cheekbones Male Mouth_Slightly_Open "
         "Mustache Narrow_Eyes No_Beard Oval_Face Pale_Skin Pointy_Nose Receding_Hairline "
         "Rosy_Cheeks Sideburns Smiling Straight_Hair Wavy_Hair Wearing_Earrings Wearing_Hat "
         "Wearing_Lipstick Wearing_Necklace Wearing_Necktie Young").split()
BLURRY = ATTRS.index("Blurry")
YAML = """# a narrow x8 face eval config
CONFIG_NAME: 'narrow_face_S8'
DATASET_NAME: 'face'
TREE:
    BRANCH_NUM: 4
    BASE_SIZE: 16
TRAIN:
    FLAG: False
    NET_G: 'absent/netG_epoch_7.pth'
GAN:
    GF_DIM: 8
    CONDITION_DIM: 10
TEXT:
    EMBEDDING_DIM: 32
    WORDS_NUM: 6
    CAPTIONS_PER_IMAGE: 1
"""


YAML16 = """# a narrow x16 face eval config
CONFIG_NAME: 'narrow_face_S16'
METHOD: 'S16'
DATASET_NAME: 'face'
TREE:
    BRANCH_NUM: 5
    BASE_SIZE: 8
TRAIN:
    FLAG: False
    NET_G: 'absent/netG_epoch_7.pth'
GAN:
    GF_DIM: 8
    CONDITION_DIM: 10
TEXT:
    EMBEDDING_DIM: 32
    WORDS_NUM: 6
    CAPTIONS_PER_IMAGE: 1
"""


def attr_rows(rng, n, n_attr=(1, 2), test_rows=1):
    """n rows of 0 / 1 attribute flags, n_attr set (never Blurry) and
    Blurry set on the last `test_rows` (the test split)."""
    rows = np.zeros((n, len(ATTRS)), int)
    others = [k for k in range(len(ATTRS)) if k != BLURRY]
    for i in range(n):
        rows[i, rng.choice(others, rng.integers(n_attr[0], n_attr[1] + 1), replace=False)] = 1
        rows[i, BLURRY] = int(i >= n - test_rows)
    return rows


def write_attr_table(path, names, rows):
    """CelebA's list_attr_celeba.txt layout as the reference reads it: a
    header of attribute names (a trailing space), then '<name>.jpg' and the
    flags, single spaces."""
    with open(path, "w") as f:
        f.write(" ".join(ATTRS) + " \n")
        for name, r in zip(names, rows):
            f.write(f"{name}.jpg " + " ".join(map(str, r)) + "\n")


def face_image(rng, h, w):
    """A uint8 RGB image of slanted ramps with noise."""
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([(yy * rng.uniform(0.5, 2) + xx * rng.uniform(0.5, 2)) % 256
                    for _ in range(3)], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def make_face_set(d, n=3, seed=0, size=(150, 140), n_attr=(1, 2)):
    """The example set in `d`; returns the vocabulary size it builds."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(d, "Img", "changetxt_im1")
    os.makedirs(img_dir, exist_ok=True)
    names = [f"{i:06d}" for i in range(n)]
    rows = attr_rows(rng, n, n_attr)
    write_attr_table(os.path.join(d, "testset.txt"), names, rows)
    for name in names:
        with open(os.path.join(img_dir, name + ".png"), "wb") as f:
            f.write(encode_png(face_image(rng, *size)))
    caps = [[ATTRS[k] for k in np.nonzero(r)[0]] for r in rows]
    return build_dictionary([c for c, r in zip(caps, rows) if not r[BLURRY]],
                            [c for c, r in zip(caps, rows) if r[BLURRY]])[2].n_words


def make_env(root, n=3, seed=0, n_attr=(1, 2), x16=False):
    """data/ (the example set), cfg.yml, ckpt/ (netG_epoch_7.pth,
    netGH_epoch_7.pth, text_encoder.pth) under `root`, of the narrow x8
    tree or (x16) the narrow S16 tree; returns a dict of their paths and the
    vocabulary size."""
    data = os.path.join(root, "data")
    n_words = make_face_set(data, n=n, seed=seed, n_attr=n_attr)
    cfg = os.path.join(root, "cfg.yml")
    with open(cfg, "w") as f:
        f.write(YAML16 if x16 else YAML)
    jcfg, _ = configs(base_size=8 if x16 else 16, gf_dim=8, condition_dim=10, embedding_dim=32,
                      words_num=6, branch_num=5 if x16 else 4)
    trees = (jax_trees16 if x16 else jax_trees)(jcfg, vocab=n_words, seed=seed)
    text_sd, netg_sd, netgh_sd, _ = state_dicts_from_jax(*trees)
    ckpt = os.path.join(root, "ckpt")
    os.makedirs(ckpt)
    for name, sd in (("netG_epoch_7.pth", netg_sd), ("netGH_epoch_7.pth", netgh_sd),
                     ("text_encoder.pth", text_sd)):
        torch.save(sd, os.path.join(ckpt, name))
    return dict(root=root, data=data, cfg=cfg, ckpt=ckpt, n_words=n_words,
                text_encoder=os.path.join(ckpt, "text_encoder.pth"))


def fresh_data(env, tag):
    """A copy of the example set for one run: each CLI writes its
    testset.pickle into the data directory."""
    d = os.path.join(env["root"], f"data_{tag}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(env["data"], d)
    return d


def common_args(env):
    return ["--cfg", env["cfg"], "--ckpt_dir", env["ckpt"], "--text_encoder",
            env["text_encoder"]]


def make_train_face_set(d, n=5, seed=0, size=(90, 80), n_attr=(1, 2)):
    """The face set in the reference's training layout in `d`:
    list_attr_celeba.txt (the last row Blurry, the test split) and PNG images
    under Img/; returns the vocabulary size it builds."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(d, "Img"), exist_ok=True)
    names = [f"{i:06d}" for i in range(n)]
    rows = attr_rows(rng, n, n_attr)
    write_attr_table(os.path.join(d, "list_attr_celeba.txt"), names, rows)
    for name in names:
        with open(os.path.join(d, "Img", name + ".png"), "wb") as f:
            f.write(encode_png(face_image(rng, *size)))
    caps = [[ATTRS[k] for k in np.nonzero(r)[0]] for r in rows]
    return build_dictionary([c for c, r in zip(caps, rows) if not r[BLURRY]],
                            [c for c, r in zip(caps, rows) if r[BLURRY]])[2].n_words
