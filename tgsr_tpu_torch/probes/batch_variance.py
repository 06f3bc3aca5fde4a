"""Batch variance of the serving forward, on the card.

    python -m tgsr_tpu_torch.probes.batch_variance [--seeds 0 1 2 3] [--draws 8]

A request served in a batch (the graph at B = 2, 4 or 8, as the HTTP
server and BatchingServer serve it) can come out different from the same
request served alone (the graph at B = 1). This probe reads how far, per
path (float32, bfloat16, int8 with bfloat16 compute, int8 with float32
compute), at the face S8 geometry (full width) with the shipped NET_E and
seeded generators: for each weights seed, int8 scales calibrated on the
card (16 images, full-length captions, as the HTTP phase of chip_smoke.py
calibrates them), then `draws` draws of 8 requests (uint8 32 px LR,
captions of 1 to WORDS_NUM tokens), each request's uint8 SR in the batch
of 2, 4 and 8 against its SR alone: the largest difference in uint8 levels
and the number of values that differ. Every reading is taken twice, and the two
must agree (the forward itself is deterministic).

Then the witness, per path, on the first draw: the eager forward at B = 1
and at B = 8 with hooks on every module, row 0 compared in call order. An
origin is a module whose inputs agree bit for bit at both batches and whose
output does not: there the batch dependence starts. The witness runs
again with the text encoder encoding one caption at a time: if then no
module call parts, the text encoder is the only origin.

On the CPU (`main(device="cpu", ...)`, as the tests run it) the same
readings come from the plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np
import torch

BATCHES = (2, 4, 8)
PATHS = ("float32", "bfloat16", "int8", "int8 f32")
VOCAB = 41


def _requests(rng: np.random.Generator, n: int, size: int, t: int):
    lr = rng.integers(0, 256, (n, size, size, 3)).astype(np.float32) / 127.5 - 1.0
    lens = rng.integers(1, t + 1, n)
    cap = rng.integers(1, VOCAB, (n, t))
    cap[np.arange(t)[None, :] >= lens[:, None]] = 0
    return lr, cap, lens


def _rows(x) -> List[torch.Tensor]:
    """The tensors of a module's inputs or output, flattened."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in _rows(item)]
    return []


def _modules(pipe) -> Dict[str, torch.nn.Module]:
    """The forward's modules by name: the text encoder as one (its LSTM
    runs as functions of its weights), every module of both generators."""
    mods = {"text_encoder": pipe.text_encoder}
    for prefix, root in (("netg", pipe.serve_netg), ("netgh", pipe.serve_netgh)):
        mods.update(root.named_modules(prefix=prefix))
    return mods


def _trace(pipe, lr, cap, lens) -> List[tuple]:
    """(name, row 0 of the inputs, row 0 of the output) of every module call
    of one eager forward, in the order the calls end."""
    calls, pending, hooks = [], {}, []
    b = lr.shape[0]

    def first(ts):
        return [t[:1].detach().clone() for t in ts if t.dim() and t.shape[0] == b]

    for name, mod in _modules(pipe).items():
        hooks.append(mod.register_forward_pre_hook(
            lambda m, args, name=name: pending.setdefault(name, []).append(
                first(_rows(args)))))
        hooks.append(mod.register_forward_hook(
            lambda m, args, out, name=name: calls.append(
                (name, pending[name].pop(), first(_rows(out))))))
    try:
        pipe(lr, cap, lens)
    finally:
        for h in hooks:
            h.remove()
    return calls


def _same(a: List[torch.Tensor], b: List[torch.Tensor]) -> bool:
    return len(a) == len(b) and all(x.shape == y.shape and torch.equal(x, y)
                                    for x, y in zip(a, b))


def _diff(a: List[torch.Tensor], b: List[torch.Tensor]) -> float:
    return max(((x.double() - y.double()).abs().max().item() for x, y in zip(a, b)
                if x.shape == y.shape), default=float("nan"))


def _text_per_row(module, args, out):
    """A forward hook that makes the text encoder's output the rows of its
    captions encoded one at a time."""
    captions, cap_lens = args
    rows = [module.forward(captions[i:i + 1], cap_lens[i:i + 1]) for i in range(len(captions))]
    return tuple(torch.cat(parts) for parts in zip(*rows))


def witness(pipe, lr, cap, lens, text_per_row: bool = False) -> Dict[str, object]:
    """Where the forward of row 0 at B = 1 and at B = len(lr) first part:
    the origins (inputs equal, output not) in call order. With
    `text_per_row` the text encoder encodes one caption at a time, which
    takes its own batch dependence out."""
    hook = pipe.text_encoder.register_forward_hook(_text_per_row) if text_per_row else None
    try:
        one = _trace(pipe, lr[:1], cap[:1], lens[:1])
        many = _trace(pipe, lr, cap, lens)
    finally:
        if hook is not None:
            hook.remove()
    if [c[0] for c in one] != [c[0] for c in many]:
        raise RuntimeError("batch_variance: the forward calls other modules at B = 1")
    mods = _modules(pipe)
    origins, parted = [], 0
    for (name, in1, out1), (_, inb, outb) in zip(one, many):
        if _same(out1, outb):
            continue
        parted += 1
        if not _same(in1, inb):
            continue
        origins.append({"module": name, "type": type(mods[name]).__name__,
                        "max_abs_diff": _diff(out1, outb)})
    sr = [outs for name, _, outs in (one[-1], many[-1])]
    return {"calls": len(one), "calls_parted": parted, "origins": origins[:8],
            "n_origins": len(origins), "last_max_abs_diff": _diff(*sr)}


def readings(pipe, rng, draws: int, size: int, t: int) -> Dict[str, object]:
    """Per batch B: each request of `draws` draws of 8 served at B against
    alone; the largest level difference, the values that differ and the
    requests with any."""
    out = {b: {"max_levels": 0, "values_differ": 0, "requests_differ": 0, "requests": 0}
           for b in BATCHES}
    for _ in range(draws):
        lr, cap, lens = _requests(rng, max(BATCHES), size, t)
        alone = np.concatenate([pipe.sr_uint8(lr[i:i + 1], cap[i:i + 1], lens[i:i + 1])
                                for i in range(len(lr))]).astype(np.int16)
        for b in BATCHES:
            d = np.abs(pipe.sr_uint8(lr[:b], cap[:b], lens[:b]).astype(np.int16) - alone[:b])
            r = out[b]
            r["max_levels"] = max(r["max_levels"], int(d.max()))
            r["values_differ"] += int((d > 0).sum())
            r["requests_differ"] += int((d.reshape(b, -1) > 0).any(1).sum())
            r["requests"] += b
    return {str(b): r for b, r in out.items()}


def main(device: str = "cuda", seeds=(0, 1, 2, 3), draws: int = 8, cfg=None,
         paths=PATHS) -> Dict[str, object]:
    from tgsr_tpu_torch.checkpoints.from_jax import init_seeded
    from tgsr_tpu_torch.checkpoints.reference import load_text_encoder
    from tgsr_tpu_torch.checkpoints.shipped import shipped_net_e
    from tgsr_tpu_torch.config import face_s8_config
    from tgsr_tpu_torch.engine.inference import SRPipeline

    cfg = cfg or face_s8_config()
    size, t = cfg.TREE.BASE_SIZE, cfg.TEXT.WORDS_NUM
    net_e = shipped_net_e(VOCAB, cfg.RNN_TYPE)
    result = {"device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
              "geometry": {"BRANCH_NUM": cfg.TREE.BRANCH_NUM, "BASE_SIZE": size,
                           "GF_DIM": cfg.GAN.GF_DIM, "imsize": cfg.imsize},
              "seeds": {}}
    for seed in seeds:
        text, netg, netgh, a = init_seeded(cfg, VOCAB, torch.Generator().manual_seed(seed))
        if net_e is not None and cfg.TEXT.EMBEDDING_DIM == 256:
            text = load_text_encoder(net_e, cfg.RNN_TYPE)
        sds = (text, netg, netgh, a)
        calib = SRPipeline(cfg, VOCAB, *sds, device=device, compute_dtype=torch.bfloat16)
        crng = np.random.default_rng(1000 + seed)
        lr_c = crng.integers(0, 256, (16, size, size, 3)).astype(np.float32) / 127.5 - 1.0
        scales = calib.calibrate_quant(lr_c, crng.integers(1, VOCAB, (16, t)), np.full(16, t))
        del calib
        per_path = {}
        for path in paths:
            kw = dict(compute_dtype=torch.float32 if path in ("float32", "int8 f32")
                      else torch.bfloat16)
            if path.startswith("int8"):
                kw["quant_scales"] = scales
            pipe = SRPipeline(cfg, VOCAB, *sds, device=device, **kw)
            twice = [readings(pipe, np.random.default_rng(seed), draws, size, t)
                     for _ in range(2)]
            lr, cap, lens = _requests(np.random.default_rng(seed), max(BATCHES), size, t)
            per_path[path] = {"readings": twice[0], "repeatable": twice[0] == twice[1],
                              "witness": witness(pipe, lr, cap, lens),
                              "witness_text_per_row": witness(pipe, lr, cap, lens, True)}
            r8 = twice[0][str(max(BATCHES))]
            w, wt = per_path[path]["witness"], per_path[path]["witness_text_per_row"]
            print(f"seed {seed} {path}: B=8 vs B=1 max {r8['max_levels']} levels, "
                  f"{r8['values_differ']} values in {r8['requests_differ']} of "
                  f"{r8['requests']} requests; repeatable {twice[0] == twice[1]}; "
                  f"{w['calls_parted']} of {w['calls']} module calls part, first origin "
                  f"{w['origins'][0] if w['origins'] else None}; text encoded per row: "
                  f"{wt['calls_parted']} part, origins {wt['origins']}", flush=True)
            del pipe
            if device == "cuda":
                torch.cuda.empty_cache()
        result["seeds"][str(seed)] = per_path
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--out", default="", help="also write the JSON result to this file")
    args = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = main(seeds=tuple(args.seeds), draws=args.draws)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "seeds"}))
