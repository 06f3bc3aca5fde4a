"""Shared set-up of the tgsr_tpu_torch training tests: the tiny x8 training
geometry of tests/test_cli_train_gan.py (BASE_SIZE 8, GF_DIM 16, DF_DIM 16;
a 32-wide text embedding and 6 caption slots) and the tiny x16 one of
tests/test_gan_trainer_x16.py (BRANCH_NUM 5, BASE_SIZE 4, GF_DIM 8, DF_DIM
8; pyramid 8 to 64 px; `width` sets GF_DIM and DF_DIM), a seeded JAX text
encoder, numpy batches, one JAX `GANTrainer` state carried into the port's,
and the port's state read back as JAX-shaped trees for comparison."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tgsr_tpu import config as jcfg_mod
from tgsr_tpu.models.text_encoder import TextEncoder as JTextEncoder
from tgsr_tpu_torch import config as tcfg_mod
from tgsr_tpu_torch.checkpoints.from_jax import (dnet_state_dict, dnet_variables,
                                                 netg_state_dict, netg_variables,
                                                 netgh_state_dict, netgh_variables)

VOCAB, T, EMB = 12, 6, 32


# BRANCH_NUM -> (BASE_SIZE, GF_DIM, DF_DIM) of the tiny training trees
GEOMETRY = {4: (8, 16, 16), 5: (4, 8, 8)}


def train_configs(branch_num=4, width=None, base_size=None, **eval_switches):
    """(tgsr_tpu Config, tgsr_tpu_torch Config) of the tiny training tree of
    the x8 (4) or x16 (5) family; `width`, if given, is GF_DIM and DF_DIM,
    `base_size` BASE_SIZE, and `eval_switches` set EVAL fields (INPUT_NETGH,
    WEIGHTMAP)."""
    base, gf, df = GEOMETRY.get(branch_num, GEOMETRY[4])
    gf, df = (gf, df) if width is None else (width, width)
    base = base if base_size is None else base_size
    out = []
    for mod in (jcfg_mod, tcfg_mod):
        cfg = mod.Config()
        out.append(dataclasses.replace(
            cfg, DATASET_NAME="face",
            TREE=dataclasses.replace(cfg.TREE, BRANCH_NUM=branch_num, BASE_SIZE=base),
            GAN=dataclasses.replace(cfg.GAN, GF_DIM=gf, DF_DIM=df, CONDITION_DIM=10),
            TEXT=dataclasses.replace(cfg.TEXT, EMBEDDING_DIM=EMB, WORDS_NUM=T),
            EVAL=dataclasses.replace(cfg.EVAL, **eval_switches)))
    return tuple(out)


def text_vars(seed=0):
    """A seeded JAX TextEncoder tree as numpy."""
    enc = JTextEncoder(vocab_size=VOCAB, nhidden=EMB)
    v = enc.init(jax.random.PRNGKey(seed), jnp.ones((1, T), jnp.int32), jnp.ones((1,), jnp.int32))
    return jax.tree.map(np.asarray, v)


def batch(b, lens, seed=0, sizes=(16, 32, 64)):
    """A numpy training batch: LR and pyramid noise in [-1, 1] (noise, not
    constants: train-mode BN of a zero-variance image divides by
    sqrt(eps) at every layer), captions padded past `lens`; the LR at half
    the first pyramid size."""
    rng = np.random.default_rng(seed)
    caps = rng.integers(1, VOCAB, (b, T)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for i, n in enumerate(lens):
        caps[i, n:] = 0
    base = sizes[0] // 2
    return {"lr": rng.uniform(-1, 1, (b, base, base, 3)).astype(np.float32),
            "real_pyramid": [rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
                             for s in sizes],
            "captions": caps, "cap_lens": lens}


def jax_batch(b):
    return jax.tree.map(jnp.asarray, b)


def load_jax_state(trainer, state, js):
    """The JAX state `js` (numpy) into the port's `state`, weights and stats."""
    netgh_sd, a = netgh_state_dict({"params": js.g_params["netgh"],
                                    "batch_stats": js.g_stats["netgh"]})
    trainer.load_state(
        state, netg_state_dict({"params": js.g_params["netg"], "batch_stats": js.g_stats["netg"]}),
        netgh_sd, a,
        {k: dnet_state_dict({"params": js.d_params[k], "batch_stats": js.d_stats[k]},
                            int(k[1:])) for k in js.d_params})


def flat(tree, prefix=""):
    """{'a/b/c': np.ndarray} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _g_trees(state, values):
    """netg and netgh trees of `values` (name -> tensor, the G parameter
    names of `g_named_parameters`) with the modules' current stats; a tied
    module's aliases (x16) take the shared tensor's value."""
    trees = {}
    for prefix, module in (("netg", state.netg), ("netgh", state.netgh)):
        sd = dict(module.state_dict())
        first = {id(p): n for n, p in module.named_parameters()}
        sd.update({n: values[f"{prefix}.{first[id(p)]}"]
                   for n, p in module.named_parameters(remove_duplicate=False)})
        a = values.get("netgh.a")  # none under a weight map
        trees[prefix] = (netg_variables(sd) if prefix == "netg"
                         else netgh_variables(sd, None if a is None else float(a.detach())))
    return trees


def port_trees(state):
    """The port's state as JAX-shaped numpy trees: g_params, g_stats, g_ema,
    g_mu (Adam's first moment), d_params, d_stats, d_mu."""
    g_named = state.g_named_parameters()
    g = _g_trees(state, dict(g_named))
    ema = _g_trees(state, state.g_ema)
    mu = _g_trees(state, {n: state.g_opt.state[p]["exp_avg"] if p in state.g_opt.state
                          else torch.zeros_like(p) for n, p in g_named})
    d, d_mu = {}, {}
    for k, dnet in state.dnets.items():
        d[k] = dnet_variables(dnet.state_dict())
        sd = dict(dnet.state_dict())
        for n, p in dnet.named_parameters():
            sd[n] = state.d_opt.state[p]["exp_avg"] if p in state.d_opt.state else torch.zeros_like(p)
        d_mu[k] = dnet_variables(sd)["params"]
    return {"g_params": {k: v["params"] for k, v in g.items()},
            "g_stats": {k: v["batch_stats"] for k, v in g.items()},
            "g_ema": {k: v["params"] for k, v in ema.items()},
            "g_mu": {k: v["params"] for k, v in mu.items()},
            "d_params": {k: v["params"] for k, v in d.items()},
            "d_stats": {k: v["batch_stats"] for k, v in d.items()},
            "d_mu": d_mu}


def load_jax_opt(state, jt):
    """JAX's Adam moments and count and its EMA (the `jax_trees` of a JAX
    state) into the port's optimizers and `g_ema`, so that a port step can
    start from a JAX state whole."""
    def g_sd(tree):
        netgh, a = netgh_state_dict({"params": tree["netgh"], "batch_stats": jt["g_stats"]["netgh"]})
        sd = {f"netg.{k}": v for k, v in netg_state_dict(
            {"params": tree["netg"], "batch_stats": jt["g_stats"]["netg"]}).items()}
        sd.update({f"netgh.{k}": v for k, v in netgh.items()})
        if a is not None:
            sd["netgh.a"] = torch.tensor(a)
        return sd

    step = torch.tensor(float(jt["count"]))
    mu, nu = g_sd(jt["g_mu"]), g_sd(jt["g_nu"])
    for n, p in state.g_named_parameters():
        state.g_opt.state[p] = {"step": step.clone(), "exp_avg": mu[n].reshape(p.shape).clone(),
                                "exp_avg_sq": nu[n].reshape(p.shape).clone()}
    state.g_ema = {n: v.reshape(p.shape).clone() for (n, p), v in
                   zip(state.g_named_parameters(), (g_sd(jt["g_ema"])[n] for n, _ in
                                                     state.g_named_parameters()))}
    for k, dnet in state.dnets.items():
        mu, nu = (dnet_state_dict({"params": jt[t][k], "batch_stats": jt["d_stats"][k]},
                                  int(k[1:])) for t in ("d_mu", "d_nu"))
        for n, p in dnet.named_parameters():
            state.d_opt.state[p] = {"step": step.clone(), "exp_avg": mu[n].clone(),
                                    "exp_avg_sq": nu[n].clone()}
