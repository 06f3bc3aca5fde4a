"""Synthetic JPEG data sets in the reference's layouts, for the dataset
adapter and CLI tests: images drawn from a seed with numpy and written by
PIL, captions from a small word list.

- `make_flower_tree`: Oxford-102 (text_c10/class_XXXXX/image_XXXXX.txt,
  jpg/image_XXXXX.jpg), '{}' placeholder lines included;
- `make_text_tree`: the AttnGAN layout of bird and COCO (train/ and test/
  filenames.pickle and class_info.pickle, text/<key>.txt), images at
  `images/<key>.jpg` (COCO: images/train2014 and images/val2014; bird:
  CUB_200_2011/images with bounding_boxes.txt and images.txt; the data
  directory's name holds "birds");
- `make_example_set`: the eval CLIs' example set of the flower, bird and
  coco configs (testset.txt names, <name>.txt captions, JPEGs under
  Img/changetxt_im1, and the train split the vocabulary comes from);
- `make_example_env`: that set, a narrow x8 YAML of the dataset, and
  seeded .pth weights (the port's `init_seeded`), which both packages
  load."""

import os
import pickle

import numpy as np
import torch
from PIL import Image

from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
from tgsr_tpu_torch.cli.test import load_config
from tgsr_tpu_torch.data.datasets import TextSRDataset
from tests.test_torch_image_fixtures import photo

WORDS = ("this flower has petals that are red yellow white purple with a green stamen and "
         "bird small beak wings long brown black dark tail the person dog on table").split()


def caption(rng, n=None):
    return " ".join(rng.choice(WORDS, int(n or rng.integers(4, 9))))


def write_jpeg(path, rng, size, **kw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    h, w = size
    Image.fromarray(photo(rng, h, w)).save(path, "JPEG", quality=int(rng.integers(70, 96)), **kw)


def _sizes(rng):
    return (int(rng.integers(70, 140)), int(rng.integers(70, 140)))


def make_flower_tree(d, seed=0, classes=3, per_class=5, embeddings_num=3):
    rng = np.random.default_rng(seed)
    k = 0
    for c in range(1, classes + 1):
        cls_dir = os.path.join(d, "text_c10", f"class_{c:05d}")
        os.makedirs(cls_dir, exist_ok=True)
        for _ in range(per_class):
            k += 1
            name = f"image_{k:05d}"
            lines = [caption(rng) for _ in range(embeddings_num + 1)]
            if k % 4 == 1:
                lines[0] = "{}"  # the reference's placeholder: repeats the previous caption
            if k % 4 == 2:
                lines[1] = "{}"
            with open(os.path.join(cls_dir, name + ".txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
            write_jpeg(os.path.join(d, "jpg", name + ".jpg"), rng, _sizes(rng),
                       progressive=bool(k % 3 == 0))
    # a file the scan must pass over
    with open(os.path.join(d, "text_c10", "README"), "w") as f:
        f.write("not a class\n")


def make_text_tree(d, kind, seed=0, n_train=5, n_test=3, embeddings_num=2):
    """kind: "coco" or "bird" (then `d`'s name must hold "birds")."""
    rng = np.random.default_rng(seed)
    splits = {"train": n_train, "test": n_test}
    images, boxes = [], []
    for split, n in splits.items():
        keys = []
        for i in range(n):
            if kind == "coco":
                key = f"COCO_{split}2014_{seed * 1000 + i:012d}"
                path = os.path.join(d, "images", "train2014" if split == "train" else "val2014",
                                    key + ".jpg")
            else:
                cls = 1 + i % 2
                key = f"{cls:03d}.Bird_{cls}/Bird_{split}_{i:04d}"
                path = os.path.join(d, "CUB_200_2011", "images", key + ".jpg")
            keys.append(key)
            size = _sizes(rng)
            write_jpeg(path, rng, size, progressive=bool(i % 2))
            if kind == "bird":
                images.append(key + ".jpg")
                bw, bh = rng.integers(20, size[1] - 10), rng.integers(20, size[0] - 10)
                boxes.append((rng.integers(0, size[1] - bw), rng.integers(0, size[0] - bh),
                              bw, bh))
            os.makedirs(os.path.dirname(os.path.join(d, "text", key + ".txt")), exist_ok=True)
            with open(os.path.join(d, "text", key + ".txt"), "w") as f:
                f.write("\n".join(caption(rng) for _ in range(embeddings_num + 1)) + "\n")
        os.makedirs(os.path.join(d, split), exist_ok=True)
        with open(os.path.join(d, split, "filenames.pickle"), "wb") as f:
            pickle.dump(keys, f, protocol=2)
        with open(os.path.join(d, split, "class_info.pickle"), "wb") as f:
            pickle.dump([1 + i % 2 for i in range(n)], f, protocol=2)
    if kind == "bird":
        with open(os.path.join(d, "CUB_200_2011", "images.txt"), "w") as f:
            f.writelines(f"{i + 1} {name}\n" for i, name in enumerate(images))
        with open(os.path.join(d, "CUB_200_2011", "bounding_boxes.txt"), "w") as f:
            f.writelines(f"{i + 1} {x:.1f} {y:.1f} {w:.1f} {h:.1f}\n"
                         for i, (x, y, w, h) in enumerate(boxes))


def make_example_set(d, seed=0, n=3, size=None):
    """The example set of the non-face eval configs in `d`; returns the
    vocabulary size the train split builds."""
    rng = np.random.default_rng(seed)
    names = [f"example_{i:03d}" for i in range(n)]
    os.makedirs(os.path.join(d, "text"), exist_ok=True)
    with open(os.path.join(d, "testset.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    for name in names:
        cap = caption(rng, 1)  # one word: one attention map to draw an image
        for path in (os.path.join(d, name + ".txt"), os.path.join(d, "text", name + ".txt")):
            with open(path, "w") as f:
                f.write(cap + "\n")
        write_jpeg(os.path.join(d, "Img", "changetxt_im1", name + ".jpg"), rng,
                   size or _sizes(rng))
    os.makedirs(os.path.join(d, "train"), exist_ok=True)
    with open(os.path.join(d, "train", "filenames.pickle"), "wb") as f:
        pickle.dump(names, f, protocol=2)
    n_words = TextSRDataset(d, split="train", embeddings_num=1).n_words
    os.remove(os.path.join(d, "captions5450.pickle"))  # each CLI builds its own
    return n_words


YAML = """# a narrow x8 {name} eval config
CONFIG_NAME: 'narrow_{name}_S8'
DATASET_NAME: '{name}'
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


def make_example_env(root, dataset="flower", n=3, seed=0):
    """data/, cfg.yml and ckpt/ (netG_epoch_7.pth, netGH_epoch_7.pth,
    text_encoder.pth) under `root`, as tests/torch_cli_data.py's make_env
    builds them for the face set (the weights drawn by the port here, not
    carried across from a JAX init, which would compile JAX's init)."""
    data = os.path.join(root, "data")
    n_words = make_example_set(data, seed=seed, n=n)
    cfg = os.path.join(root, "cfg.yml")
    with open(cfg, "w") as f:
        f.write(YAML.format(name=dataset))
    text_sd, netg_sd, netgh_sd, _ = init_seeded(load_config(cfg), n_words,
                                                torch.Generator().manual_seed(seed))
    ckpt = os.path.join(root, "ckpt")
    os.makedirs(ckpt)
    for name, sd in (("netG_epoch_7.pth", netg_sd), ("netGH_epoch_7.pth", netgh_sd),
                     ("text_encoder.pth", text_sd)):
        torch.save(sd, os.path.join(ckpt, name))
    return dict(root=root, data=data, cfg=cfg, ckpt=ckpt, n_words=n_words,
                text_encoder=os.path.join(ckpt, "text_encoder.pth"))
