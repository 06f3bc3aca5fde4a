"""DAMSM encoder pretraining (counterpart of tgsr_tpu/engine/damsm_trainer.py,
`DAMSMTrainer` :46-368; = pretrain_DAMSM.py).

The bidirectional LSTM or GRU text encoder and the CNN image encoder train together on the
symmetric words + sentence contrastive losses, step for step as the JAX
trainer:

- Adam(lr, b1 0.5, b2 0.999) over the text encoder and the CNN's trainable
  parameters: the Inception heads (the backbone is frozen, and gets no
  moments; JAX's moments for it stay zero), or the whole SimpleCNNEncoder;
- `epoch_lr`: lr times 0.98 an epoch down to a floor of lr / 10, and the
  Adam moments and step count reset at the start of every epoch after the
  first (`reset_optimizer`, the reference re-creating its optimizer);
- the text gradients scaled by min(1, clip / max(|g_text|, 1e-12)), JAX's
  formula (`torch.nn.utils.clip_grad_norm_`'s clip / (norm + 1e-6) is
  another number), the CNN's left as they are;
- BN in train mode in the whole CNN, the frozen backbone included, so its
  running stats move as JAX's do; eval mode never touches them;
- loss w0 + w1 + s0 + s1; metrics `w_loss`, `s_loss`, `loss`,
  `rnn_grad_norm`;
- `compute_dtype=torch.bfloat16`: the CNN computes in bfloat16 from float32
  masters (`engine/precision.call_cast`), its BN moments and stats in
  float32; the text encoder and the losses stay float32;
- dropout on the word embeddings from a CPU generator seeded by (seed,
  global step), so that a resume at an epoch boundary replays the
  uninterrupted run exactly (JAX's `fast_forward_key`);
- TF32 off in every step (`engine/precision.float32_math`), whatever the
  process's switches say.

Where JAX returns a new state from a jitted step, the port updates the
state in place and returns the metrics, 0-d tensors on the device. Not
ported: `mesh` (ROADMAP A 10).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from tgsr_tpu_torch.checkpoints.from_jax import (cnn_encoder_variables, init_module,
                                                 seeded_text_state_dict, text_variables)
from tgsr_tpu_torch.config import Config
from tgsr_tpu_torch.engine.inference import resolve_device
from tgsr_tpu_torch.engine.precision import COMPUTE_DTYPES, call_cast, float32_math
from tgsr_tpu_torch.losses.damsm import sent_loss, words_loss
from tgsr_tpu_torch.models.image_encoder import CNNEncoder, make_image_encoder
from tgsr_tpu_torch.models.text_encoder import TextEncoder
from tgsr_tpu_torch.ops.image import normalize_uint8

ADAM_BETAS = (0.5, 0.999)  # pretrain_DAMSM.py:270
EVAL_BATCHES = 50  # the batches `evaluate` reads (pretrain_DAMSM.py:133-163)


@dataclass
class DAMSMState:
    """What a step reads and updates, in place: the two encoders (float32
    masters and the CNN's BN running stats), their optimizer and the global
    step (which seeds the step's dropout)."""

    step: int
    text: TextEncoder
    cnn: nn.Module
    opt: torch.optim.Optimizer

    def snapshot_variables(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """The (text_encoder, image_encoder) flax trees a snapshot writes:
        {'params'} and {'params', 'batch_stats'}, as JAX's CLI saves them."""
        text = {k: v.detach().cpu() for k, v in self.text.state_dict().items()}
        cnn = {k: v.detach().cpu() for k, v in self.cnn.state_dict().items()}
        return text_variables(text), cnn_encoder_variables(cnn)


class DAMSMTrainer:
    def __init__(self, cfg: Config, vocab_size: int, use_inception: bool = True,
                 compute_dtype: torch.dtype = torch.float32, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        """`use_inception`: CNNEncoder, its backbone frozen (JAX's default
        freeze_backbone), else SimpleCNNEncoder, all of it trained. `seed`
        seeds the dropout of every step with the global step. `device` is
        the card unless the caller asks for the CPU."""
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype}: the DAMSM trainer computes in "
                             f"{COMPUTE_DTYPES}")
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.use_inception = use_inception
        self.compute_dtype = compute_dtype
        self.seed = seed
        self.device = resolve_device(device)
        self.base_lr = cfg.TRAIN.ENCODER_LR
        self.grad_clip = cfg.TRAIN.RNN_GRAD_CLIP
        s = cfg.TRAIN.SMOOTH
        self.gammas = (s.GAMMA1, s.GAMMA2, s.GAMMA3)

    def epoch_lr(self, epoch: int) -> float:
        """lr *= 0.98 an epoch with a floor of lr / 10 (pretrain_DAMSM.py:283-284)."""
        lr = self.base_lr
        for _ in range(epoch):
            if lr > self.base_lr / 10.0:
                lr *= 0.98
        return lr

    # -- state -------------------------------------------------------------------

    def init_state(self, generator: torch.Generator) -> DAMSMState:
        """Fresh encoders from `generator` (a CPU generator) with the JAX
        init's distributions: the embedding U(-0.1, 0.1), the LSTM or GRU U(-1 /
        sqrt(H), 1 / sqrt(H)), convs and Dense N(0, 1 / fan_in), the
        Inception heads U(-0.1, 0.1), biases 0, BN (1, 0) and stats (0, 1)."""
        cfg = self.cfg
        text = TextEncoder(self.vocab_size, 300, cfg.TEXT.EMBEDDING_DIM, rnn_type=cfg.RNN_TYPE)
        text.load_state_dict(seeded_text_state_dict(cfg, self.vocab_size, generator))
        cnn = make_image_encoder(not self.use_inception, cfg.TEXT.EMBEDDING_DIM)
        init_module(cnn, generator)
        if isinstance(cnn, CNNEncoder):
            with torch.no_grad():
                for w in (cnn.emb_features.weight, cnn.emb_cnn_code.weight):
                    w.copy_(torch.rand(w.shape, generator=generator) * 0.2 - 0.1)
        text.to(self.device)
        cnn.to(self.device)
        return DAMSMState(step=0, text=text, cnn=cnn, opt=self._make_opt(text, cnn))

    def trainable(self, text: nn.Module, cnn: nn.Module) -> List[Tuple[str, torch.Tensor]]:
        """The optimised parameters by name ("text.<name>", "cnn.<name>"):
        the text encoder, and the CNN without its frozen backbone."""
        out = [(f"text.{n}", p) for n, p in text.named_parameters()]
        for n, p in cnn.named_parameters():
            if not self.use_inception or n.startswith("emb_"):
                out.append((f"cnn.{n}", p))
        return out

    def _make_opt(self, text, cnn) -> torch.optim.Optimizer:
        params = [p for _, p in self.trainable(text, cnn)]
        return torch.optim.Adam(params, lr=self.base_lr, betas=ADAM_BETAS)

    def reset_optimizer(self, state: DAMSMState) -> None:
        """= the reference's per-epoch optimizer reconstruction
        (pretrain_DAMSM.py:269-270): zero moments, step count 0."""
        state.opt = self._make_opt(state.text, state.cnn)

    def load_state(self, state: DAMSMState, text_sd: Optional[Mapping[str, torch.Tensor]] = None,
                   cnn_sd: Optional[Mapping[str, torch.Tensor]] = None) -> None:
        """Loads encoder weights into `state`: a text state dict (strict),
        and image-encoder entries (a partial one, such as a zoo backbone,
        keeps the rest), in place; the optimizer is left as it is."""
        with torch.no_grad():
            if text_sd is not None:
                state.text.load_state_dict(text_sd, strict=True)
            if cnn_sd is not None:
                own = state.cnn.state_dict()
                unknown = set(cnn_sd) - set(own)
                if unknown:
                    raise ValueError(f"image encoder entries {sorted(unknown)[:4]} are not "
                                     f"the {type(state.cnn).__name__}'s")
                state.cnn.load_state_dict({**own, **cnn_sd}, strict=True)

    # -- the step -------------------------------------------------------------------

    def dropout_generator(self, step: int) -> torch.Generator:
        """The CPU generator of the dropout of global step `step`."""
        return torch.Generator().manual_seed((self.seed << 32) + step)

    def _apply_cnn(self, state: DAMSMState, imgs: torch.Tensor, train: bool):
        """(features, code) in float32, the CNN in the compute dtype; in
        train mode its BN running stats move (float32)."""
        state.cnn.train(train)
        dt = self.compute_dtype
        feat, code = call_cast(state.cnn, dt, imgs.to(dt), buffers=not train)
        return feat.float(), code.float()

    def _loss(self, state: DAMSMState, batch: Mapping[str, torch.Tensor], train: bool):
        feat, code = self._apply_cnn(state, batch["imgs"], train)
        state.text.train(train)
        gen = self.dropout_generator(state.step) if train else None
        words, sent = state.text(batch["captions"], batch["cap_lens"], generator=gen)
        g1, g2, g3 = self.gammas
        class_ids = batch.get("class_ids")
        w0, w1, attn = words_loss(feat, words, batch["cap_lens"], class_ids, g1, g2, g3)
        s0, s1 = sent_loss(code, sent, class_ids, g3)
        total = w0 + w1 + s0 + s1
        return total, {"w_loss": w0 + w1, "s_loss": s0 + s1, "loss": total}, attn

    @float32_math()
    def train_step(self, state: DAMSMState, batch: Mapping[str, torch.Tensor],
                   lr: float) -> Dict[str, torch.Tensor]:
        """One Adam step at `lr` on a device batch (`device_batch`), in
        place. Returns the metrics."""
        names, params = zip(*self.trainable(state.text, state.cnn))
        loss, metrics, _ = self._loss(state, batch, True)
        grads = list(torch.autograd.grad(loss, params))
        n_text = sum(n.startswith("text.") for n in names)
        tnorm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads[:n_text]]))
        scale = torch.clamp(self.grad_clip / torch.clamp(tnorm, min=1e-12), max=1.0)
        for i, (p, g) in enumerate(zip(params, grads)):
            p.grad = g * scale if i < n_text else g
        for group in state.opt.param_groups:
            group["lr"] = lr
        state.opt.step()
        for p in params:
            p.grad = None
        state.step += 1
        metrics["rnn_grad_norm"] = tnorm
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    @float32_math()
    def eval_step(self, state: DAMSMState, batch: Mapping[str, torch.Tensor]
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Eval-mode losses and the words loss's attention maps [B, T, R];
        nothing moves."""
        _, metrics, attn = self._loss(state, batch, False)
        return metrics, attn

    @torch.no_grad()
    @float32_math()
    def embed_step(self, state: DAMSMState, batch: Mapping[str, torch.Tensor]):
        """Eval-mode DAMSM embeddings of a batch: (region features [N, R, E],
        image codes [N, E], word embeddings [N, T, E], sentences [N, E]),
        the inputs of `engine.evaluator.rank_r_precision`."""
        feat, code = self._apply_cnn(state, batch["imgs"], False)
        state.text.eval()
        words, sent = state.text(batch["captions"], batch["cap_lens"])
        return feat, code, words, sent

    # -- epoch driver ---------------------------------------------------------------

    def fit(self, state: DAMSMState, train_loader, val_loader=None, epochs: int = 1,
            log_every: int = 200, snapshot_fn: Optional[Callable] = None,
            snapshot_interval: int = 0, logger=None, start_epoch: int = 0,
            global_step_offset: int = 0):
        """JAX's epoch driver. The state updates in place, so the caller's
        `state` is always the live one (JAX's `state_sink` has no work
        here). `start_epoch`: the resume point (the snapshot's epoch + 1);
        `global_step_offset` = start_epoch * batches an epoch, which also
        restarts the dropout stream where the uninterrupted run had it.
        Metrics are fetched at the log points only, and a non-finite one
        there aborts (FloatingPointError). Returns (state, history)."""
        history = []
        state.step = global_step_offset
        for epoch in range(start_epoch, epochs):
            lr = self.epoch_lr(epoch)
            if epoch > 0:
                self.reset_optimizer(state)
            for i, batch in enumerate(train_loader.epoch(epoch)):
                metrics = self.train_step(state, self.device_batch(batch), lr)
                if log_every and i % log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    history.append({"epoch": epoch, "it": i, "lr": lr, **m})
                    if logger is not None:
                        logger.log(state.step, epoch=epoch, lr=lr, **m)
                    bad = [k for k, v in m.items() if not math.isfinite(v)]
                    if bad:
                        raise FloatingPointError(
                            f"NaN/Inf in DAMSM metrics {bad} at epoch {epoch} it {i}; resume "
                            f"from the last snapshot with a lower ENCODER_LR")
            if val_loader is not None:
                vloss = self.evaluate(state, val_loader)
                history.append({"epoch": epoch, "val": vloss})
                if logger is not None:
                    logger.log(state.step, epoch=epoch, val=vloss)
            if snapshot_fn and snapshot_interval and (
                    epoch % snapshot_interval == 0 or epoch == epochs - 1):
                snapshot_fn(state, epoch)
        return state, history

    def evaluate(self, state: DAMSMState, val_loader) -> float:
        """The mean eval loss over up to EVAL_BATCHES batches (= evaluate,
        pretrain_DAMSM.py:133-163)."""
        tot, n = 0.0, 0
        for i, batch in enumerate(val_loader.epoch(0)):
            if i >= EVAL_BATCHES:
                break
            metrics, _ = self.eval_step(state, self.device_batch(batch))
            tot += float(metrics["loss"])
            n += 1
        return tot / n if n else float("nan")

    def device_batch(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """A host batch (`prepare_batch`'s) -> the step's: images NHWC in
        [-1, 1] (uint8 normalised on the device), captions, lengths and
        class ids."""
        dev = self.device
        imgs = normalize_uint8(torch.as_tensor(np.asarray(batch["hr"]), device=dev))
        return {"imgs": imgs,
                "captions": torch.as_tensor(np.asarray(batch["captions"]), device=dev,
                                            dtype=torch.long),
                "cap_lens": torch.as_tensor(np.asarray(batch["cap_lens"]), device=dev,
                                            dtype=torch.long),
                "class_ids": torch.as_tensor(np.asarray(batch["class_ids"]), device=dev)}

