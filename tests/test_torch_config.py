"""tgsr_tpu_torch/config.py against tgsr_tpu/config.py: partial dicts merge
over the same schema defaults; every file in configs/ loads to the same
field values in both packages (the x8 family, BRANCH_NUM 4, and the x16
family, BRANCH_NUM 5, the JAX schema's default); a BRANCH_NUM the port does
not serve (3, 6) raises NotImplementedError; unknown keys and
mismatched types raise the same KeyError / ValueError. The port's YAML
reader against yaml.safe_load on every file in configs/, and on what it
must refuse."""

import dataclasses
import glob
import os

import pytest
import yaml

from tgsr_tpu import config as jconfig
from tgsr_tpu_torch import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yml")))


def test_defaults_are_the_jax_schema():
    """Every field, with the JAX schema's default (the port's dataclasses
    order the serving fields first, so compare as dicts)."""
    assert tconfig.config_to_dict(tconfig.Config()) == jconfig.config_to_dict(jconfig.Config())


@pytest.mark.parametrize("partial", [
    {"TREE": {"BRANCH_NUM": 4}},
    {"TREE": {"BRANCH_NUM": 4, "BASE_SIZE": 16}, "GAN": {"GF_DIM": 8}},
    {"TREE": {"BRANCH_NUM": 4}, "TRAIN": {"NET_E": "x.pth", "SMOOTH": {"GAMMA1": 4}},
     "EVAL": {"NO_STOPWORD": True, "TEXT_BATCH_NUM": 7}, "METHOD": "S8"},
    {"TREE": {"BRANCH_NUM": 4}, "TEXT": {"CAPTIONS_PER_IMAGE": 1}, "B_VALIDATION": True},
    {}, {"TREE": {"BRANCH_NUM": 5, "BASE_SIZE": 32}, "GAN": {"GF_DIM": 32}, "METHOD": "S16"},
])
def test_partial_dicts_match_jax(partial):
    got = tconfig.config_from_dict(partial)
    want = jconfig.config_from_dict(partial)
    assert tconfig.config_to_dict(got) == jconfig.config_to_dict(want)
    assert (got.scale, got.imsize, got.n_stages, got.pyramid_sizes()) == (
        want.scale, want.imsize, want.n_stages, want.pyramid_sizes())


def test_branch_num_alone_gives_the_jax_widths():
    cfg = tconfig.config_from_dict({"TREE": {"BRANCH_NUM": 4}})
    assert (cfg.TREE.BASE_SIZE, cfg.GAN.GF_DIM) == (64, 128)
    assert isinstance(cfg.TRAIN.SMOOTH.GAMMA1, float)


def test_face_s8_config_is_the_schema_at_face_s8():
    j = jconfig.Config()
    j = dataclasses.replace(j, TREE=dataclasses.replace(j.TREE, BRANCH_NUM=4, BASE_SIZE=32),
                            GAN=dataclasses.replace(j.GAN, GF_DIM=32))
    assert tconfig.config_to_dict(tconfig.face_s8_config()) == jconfig.config_to_dict(j)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_files_match_jax(path):
    with open(path) as f:
        raw = yaml.safe_load(f)
    with open(path) as f:
        assert tconfig.load_yaml(f.read(), path) == raw
    want = jconfig.config_from_file(path)
    assert want.TREE.BRANCH_NUM in (4, 5)
    got = tconfig.config_from_file(path)
    assert tconfig.config_to_dict(got) == jconfig.config_to_dict(want)


@pytest.mark.parametrize("branch_num", [3, 6])
def test_unserved_branch_nums_raise(branch_num):
    """JAX builds any BRANCH_NUM (its family switch sends every value but 4 to
    models16); the port serves 4 and 5 and refuses the rest by name."""
    d = {"TREE": {"BRANCH_NUM": branch_num}}
    assert jconfig.config_from_dict(d).TREE.BRANCH_NUM == branch_num
    with pytest.raises(NotImplementedError, match="BRANCH_NUM = %d" % branch_num):
        tconfig.config_from_dict(d)


@pytest.mark.parametrize("bad", [
    {"NOT_A_KEY": 1}, {"TREE": {"NOT_A_KEY": 1}}, {"TRAIN": {"SMOOTH": {"GAMMA9": 1.0}}},
    {"EVAL": {"NOT_A_KEY": 1}},
])
def test_unknown_keys_raise_like_jax(bad):
    with pytest.raises(KeyError):
        jconfig.config_from_dict(bad)
    with pytest.raises(KeyError):
        tconfig.config_from_dict(bad)


@pytest.mark.parametrize("bad", [
    {"GAN": {"GF_DIM": "32"}}, {"TREE": {"BASE_SIZE": True}}, {"TRAIN": {"FLAG": 1}},
    {"TRAIN": {"SMOOTH": 3}}, {"TEXT": {"WORDS_NUM": 18.0}}, {"CONFIG_NAME": 0},
])
def test_mismatched_types_raise_like_jax(bad):
    with pytest.raises(ValueError):
        jconfig.config_from_dict(bad)
    with pytest.raises(ValueError):
        tconfig.config_from_dict({**bad, "TREE": {"BRANCH_NUM": 4, **bad.get("TREE", {})}})


@pytest.mark.parametrize("text, line", [
    ("A: 1\nB:\n  - x\n", 3), ("A: [1, 2]\n", 1), ("A: {b: 1}\n", 1), ("A: &x 1\n", 1),
    ("A: |\n  text\n", 1), ("A: 1\n  B: 2\n", 2), ("A:\nB: 1\n", 2), ("A: null\n", 1),
    ("A: 1\nA: 2\n", 2), ("A: 'open\n", 1), ("A:\n\tB: 1\n", 2), ("A: yes\n", 1),
])
def test_yaml_reader_refuses_with_the_line(text, line):
    with pytest.raises(ValueError, match=f"x.yml:{line}"):
        tconfig.load_yaml(text, "x.yml")


def test_yaml_reader_scalars_match_pyyaml():
    text = ("I: -3\nF: 2.5\nE: 1.0e-3\nD: .5\nT: True\nF2: false\nS: 'it''s # not'\n"
            "Q: \"dq\"\nB: bare words  # a comment\nP: ../a/b.pth\nM:\n    N:\n        K: 1\n")
    assert tconfig.load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["A: 1.0e3\n", "A: 012\n", "A: 0x1F\n", "A: 1_000\n",
                                  "A: 12:30\n"])
def test_yaml_reader_refuses_numbers_outside_the_subset(text):
    """YAML 1.1 reads these as a string, an int or a sexagesimal: refused."""
    with pytest.raises(ValueError, match="plain decimals"):
        tconfig.load_yaml(text, "x.yml")
