"""HTTP serving entry point: text-guided SR as a network service
(counterpart of tgsr_tpu/cli/serve.py, with the same protocol).

  python -m tgsr_tpu_torch.cli.serve --artifact <bundle dir> [--port 8718]
  python -m tgsr_tpu_torch.cli.serve --cfg <eval yml> --netg <netG_epoch_7.pth> \\
      --vocab_pickle <testset.pickle> [--int8 | --scales s.json | --f32]
  python -m tgsr_tpu_torch.cli.serve --aot <cli.export_aot dir> --vocab_pickle <pickle>

Protocol (stdlib http.server; images through data/codec.py):
  POST /sr     body = a PNG (any colour type, bit depth, interlace) or a
               JPEG (baseline or progressive), read as PIL's
               convert("RGB") reads it; bicubic-resized (PIL's filter) to the model's
               LR size and batched with concurrent requests through
               engine/serving.py's BatchingServer. Caption in the
               `X-Caption` header (or `?caption=`). Response: image/png.
  POST /sr?mode=native
               the body is the LR at its own size, cropped down to a
               multiple of the scale, through SRPipeline.sr_arbitrary with
               bucket=64; native requests are not batched. An exported
               program (--aot, engine/aot.py AOTPipeline) has fixed shapes
               and answers 400, as does a pipeline with weight maps
               (EVAL.WEIGHTMAP) at an LR size its maps do not fit.
  GET /healthz JSON: request and batch counts, latency percentiles.
A body that is not a PNG or JPEG the codec reads (GIF, BMP, TIFF, WebP,
arithmetic-coded or 12-bit JPEG, a corrupt or truncated file) is answered
400 with the reason; an unknown path 404; a failed forward 500.

ThreadingHTTPServer runs each request on its own thread: fixed-size
requests wait on their futures while BatchingServer's collector thread
replays the captured graphs; a native request runs sr_arbitrary on its own
thread. The pipeline's lock (`SRPipeline.lock`) serialises the two on the
card, where the JAX package lets them overlap.

`boot(argv)` builds (pipeline, vocab, args) from the command line without
serving, for tests and smoke runs; `main` boots, warms every planned batch
size up, and serves until SIGINT or SIGTERM, then drains.
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from tgsr_tpu_torch.data.codec import (decode_image, encode_png, jpeg_library,
                                       resize_pil_bicubic, unfilter_library)
from tgsr_tpu_torch.data.tokenizer import Vocab, encode_caption, tokenize_caption
from tgsr_tpu_torch.engine.serving import BatchingServer
from tgsr_tpu_torch.models.generator_hf import WeightMapSizeError


def aot_max_batch(meta, requested: int) -> int:
    """A pinned-batch exported program (export_serving batch_size=N) runs
    batches <= N only: the serving batch plan is clamped to the pin, so that
    warm-up and coalesced batches never exceed it (AOTPipeline pads short
    batches up to it). A symbolic-batch program passes `requested` through."""
    pin = meta.get("batch")
    if isinstance(pin, int) and requested > pin:
        return pin
    return requested


def encode_caption_text(text: str, vocab: Vocab, words_num: int,
                        rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, int]:
    """Caption string -> ([T] int32 ids, length): tokenized, unknown words
    dropped; a caption longer than T keeps a sorted random subsample."""
    ids = vocab.encode_tokens(tokenize_caption(text))
    cap, n = encode_caption(ids, words_num, rng)
    return cap.astype(np.int32), n


def make_server(pipeline, vocab: Vocab, host: str = "127.0.0.1", port: int = 8718,
                max_batch: int = 32, max_delay_ms: float = 5.0,
                lr_size: Optional[int] = None) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server around a BatchingServer. Call
    .serve_forever() (blocking) or drive it from a thread; `.batcher` is
    the BatchingServer, to warm up and to close after `shutdown()`."""
    T = pipeline.cfg.TEXT.WORDS_NUM
    size = lr_size or pipeline.cfg.TREE.BASE_SIZE
    scale = pipeline.cfg.scale
    batcher = BatchingServer(pipeline, max_batch=max_batch, max_delay_ms=max_delay_ms,
                             lr_shape=(size, size, 3))
    unfilter_library()  # the decoders' C code, built before the first request
    jpeg_library()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, kind: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", kind)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if urlparse(self.path).path != "/healthz":
                return self._json(404, {"error": "unknown path"})
            st = batcher.stats_snapshot()
            self._json(200, {"status": "ok", "requests": st["requests"],
                             "batches": st["batches"],
                             "batch_hist": {str(k): v for k, v in st["batch_hist"].items()},
                             **batcher.latency_percentiles()})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/sr":
                return self._json(404, {"error": "unknown path"})
            query = parse_qs(url.query)
            caption = self.headers.get("X-Caption", "") or query.get("caption", [""])[0]
            try:
                n = int(self.headers.get("Content-Length", "0"))
                img = decode_image(self.rfile.read(n))
            except Exception as e:  # whatever the body holds, the client gets an answer
                return self._json(400, {"error": f"bad image: {e}"})
            cap, length = encode_caption_text(caption, vocab, T)
            mode = query.get("mode", ["fixed"])[0]
            try:
                if mode == "native":
                    if not hasattr(pipeline, "sr_arbitrary"):
                        return self._json(400, {
                            "error": "native mode unavailable: this server runs an AOT "
                                     "artifact with fixed shapes (export_serving)"})
                    # cropped down to a multiple of the scale
                    h0, w0 = (img.shape[0] // scale) * scale, (img.shape[1] // scale) * scale
                    if h0 < scale or w0 < scale:
                        return self._json(400, {"error": f"image below one {scale}px tile"})
                    lr = img[:h0, :w0].astype(np.float32) / 127.5 - 1.0
                    sr = pipeline.sr_arbitrary(lr[None], cap[None],
                                               np.asarray([length], np.int32), bucket=64)[0]
                elif mode == "fixed":
                    lr = resize_pil_bicubic(img, (size, size)).astype(np.float32) / 127.5 - 1.0
                    sr = batcher.submit(lr, cap, length).result(timeout=600)
                else:
                    return self._json(400, {"error": f"bad mode {mode!r}"})
            except WeightMapSizeError as e:  # an LR size the weight maps do not fit
                return self._json(400, {"error": str(e)})
            except Exception as e:  # the request thread answers; the server lives on
                return self._json(500, {"error": str(e)})
            self._send(200, encode_png(sr), "image/png")

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.batcher = batcher
    return httpd


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="TGSR SR service (PyTorch/CUDA)")
    parser.add_argument("--artifact", default="",
                        help="deployment bundle dir (SRPipeline.save_artifact) - replaces "
                             "--cfg/--netg/--vocab_pickle")
    parser.add_argument("--aot", default="",
                        help="exported program dir (engine.aot.export_serving, cli.export_aot): "
                             "serve the exported forward, no model code or checkpoints load; "
                             "precision and int8 are fixed at export, so --int8/--f32 are "
                             "refused. Needs --vocab_pickle. Native mode answers 400 (fixed "
                             "shapes)")
    parser.add_argument("--cfg", dest="cfg_file", default="")
    parser.add_argument("--netg", default="",
                        help="reference netG_epoch_*.pth (netGH resolved alongside)")
    parser.add_argument("--vocab_pickle", default="")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8718)
    parser.add_argument("--max_batch", type=int, default=32)
    parser.add_argument("--max_delay_ms", type=float, default=5.0)
    parser.add_argument("--int8", action="store_true",
                        help="int8 serving with the shipped face_S8 scales (--cfg path) or "
                             "the bundle's scales (--artifact)")
    parser.add_argument("--scales", default="",
                        help="int8 serving with a calibrated scales JSON (--cfg path)")
    parser.add_argument("--f32", action="store_true", help="full float32 (default bfloat16)")
    parser.add_argument("--text_encoder", default="",
                        help="trained text-encoder weights (.pth or .msgpack) for the "
                             "--cfg/--netg boot path")
    parser.add_argument("--seeded-text", action="store_true",
                        help="the seeded-init text encoder instead of cfg NET_E or the "
                             "shipped trained NET_E")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cpu runs every kernel site's plain version)")
    return parser.parse_args(argv)


def boot(argv=None):
    """(pipeline, vocab, args) from the command line, as `main` serves
    them. Raises SystemExit on an inconsistent set of arguments."""
    from tgsr_tpu_torch.cli.eval_rank import load_vocab

    args = parse_args(argv)
    if args.scales and (args.int8 or args.f32 or args.artifact or args.aot):
        raise SystemExit("--scales selects int8 for the --cfg/--netg boot path; drop "
                         "--int8/--f32 (and use the bundle's own scales with --artifact/--aot)")
    if args.aot:
        if args.int8 or args.f32:
            raise SystemExit("--aot artifacts bake precision/quantization at export time; "
                             "drop --int8/--f32")
        if not args.vocab_pickle:
            raise SystemExit("--aot needs --vocab_pickle (caption encoding stays host-side)")
        from tgsr_tpu_torch.engine.aot import AOTPipeline

        pipe = AOTPipeline(args.aot, device=args.device)
        vocab = load_vocab(args.vocab_pickle)
        # the embedding table is inside the program: ids of another vocabulary
        # index past it (an error on the CPU, a fault on the card) or give
        # garbage, so refuse up front
        n_words = pipe.meta.get("n_words")
        if n_words is not None and vocab.n_words != n_words:
            raise SystemExit(f"--vocab_pickle has {vocab.n_words} words but the AOT artifact "
                             f"was exported with a {n_words}-word vocabulary; serve the pickle "
                             "the model was trained with")
        clamped = aot_max_batch(pipe.meta, args.max_batch)
        if clamped != args.max_batch:
            print(f"[serve] artifact pins batch {clamped}: clamping --max_batch "
                  f"{args.max_batch} -> {clamped}", flush=True)
            args.max_batch = clamped
        return pipe, vocab, args
    from tgsr_tpu_torch.engine.inference import SRPipeline

    if args.artifact:
        pipe, vocab = SRPipeline.load_artifact(
            args.artifact, device=args.device,
            compute_dtype=torch.float32 if args.f32 else None,
            use_quant=True if args.int8 else False if args.f32 else None)
        if vocab is None:
            if not args.vocab_pickle:
                raise SystemExit("artifact has no vocab.json: pass --vocab_pickle")
            vocab = load_vocab(args.vocab_pickle)
        return pipe, vocab, args
    if not (args.cfg_file and args.netg and args.vocab_pickle):
        raise SystemExit("pass --artifact OR --cfg + --netg + --vocab_pickle")
    from tgsr_tpu_torch.checkpoints.shipped import resolve_net_e
    from tgsr_tpu_torch.config import config_from_file
    from tgsr_tpu_torch.engine.quant import face_s8_scales

    cfg = config_from_file(args.cfg_file)
    vocab = load_vocab(args.vocab_pickle)
    quant = None
    if args.scales:
        with open(args.scales) as f:
            quant = json.load(f)
    elif args.int8:
        # as the JAX package: the shipped face S8 scales, whatever the family
        quant = face_s8_scales()
    # flag > cfg NET_E > shipped trained NET_E > seeded
    net_e_path, net_e_src = resolve_net_e(cfg, args.text_encoder, vocab.n_words,
                                          seeded=args.seeded_text)
    print(f"[serve] text encoder: {net_e_src}", flush=True)
    try:
        pipe = SRPipeline.from_reference_checkpoints(
            cfg, vocab.n_words, args.netg, text_encoder_path=net_e_path, device=args.device,
            compute_dtype=torch.float32 if args.f32 else torch.bfloat16,
            quant_scales=quant)
    except ValueError as e:
        if not args.int8:
            raise
        raise ValueError(f"--int8 serves the shipped face S8 scales, calibrated for the x8 "
                         f"family's face_S8 checkpoints; for these weights calibrate them "
                         f"(tgsr_tpu_torch.cli.calibrate) and pass --scales: {e}") from e
    return pipe, vocab, args


def main(argv=None):
    from tgsr_tpu_torch.utils.preemption import graceful_sigterm

    pipe, vocab, args = boot(argv)
    httpd = make_server(pipe, vocab, host=args.host, port=args.port,
                        max_batch=args.max_batch, max_delay_ms=args.max_delay_ms)
    print("warming up (a graph captured per planned batch size)...", flush=True)
    httpd.batcher.warmup()
    kind = ("aot" if args.aot else "int8" if pipe.quant_scales
            else "f32" if pipe.compute_dtype == torch.float32 else "bf16")
    print(f"serving on http://{args.host}:{httpd.server_address[1]} (max_batch "
          f"{args.max_batch}, delay {args.max_delay_ms} ms, {kind}, {pipe.device})", flush=True)
    try:
        # SIGTERM (a container stop) drains like Ctrl-C: stop accepting, then
        # batcher.close() finishes the batches in flight
        with graceful_sigterm():
            httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()


if __name__ == "__main__":
    main()
