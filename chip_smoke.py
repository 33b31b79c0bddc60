"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main path, LEVIR-CD evaluation of DAHiTra
(``newUNetTrans``) at its published width and 256 px, through the user's
entry point ``dahitra_tpu_torch.cli.eval_cd``. Phases, each fatal on
failure:

  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from ``dahitra_tpu_torch/csrc`` (one nvcc per
     source, all started together);
  3. hold each kernel against its plain PyTorch version on the card at every
     shape the main path gives it, in fp32 and bf16, and time the kernel,
     the plain version and, where one exists, a single PyTorch call that
     computes the same function;
  4. write a seeded synthetic LEVIR tree (4 tiles of 1024 px = 64 patches of
     256 px) and a seeded ``best_ckpt.pt``;
  5. run ``eval_cd`` on the card at batch 8, once in fp32 and once with
     ``--bf16``, with every launch counter set to 0 just before each run and
     read just after: K1 must launch 6 times and K3 3 times per forward;
  6. hold the card's fp32 forward (kernels) against the port's plain path on
     the CPU for two patches.

``--profile`` adds, after phase 6, a torch.profiler breakdown of the
batch-8 forward by kernel class, with the device's idle share.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Exits non-zero, printing neither, when no
CUDA device is present or the port's package is missing. Needs one card;
imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
BATCH = 8
IMG = 256
# Scale-normalized max-error tolerances: fp32 allows summation-order noise;
# bf16 allows a flipped rounding that a depth-8 stack carries forward.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Decoder calls per forward at batch 8: (name, batch, tokens, depth, heads).
# The dates decode runs both dates batch-stacked, the difference decode once.
K1_SHAPES = [(f"{r}/{what}", b, n, depth, heads)
             for r, n, depth, heads in (("s4", 4096, 8, 8), ("s8", 1024, 4, 4),
                                        ("s16", 256, 4, 4))
             for what, b in (("dates", 2 * BATCH), ("diff", BATCH))]
K3_SHAPES = [(f"s{s}", 2 * BATCH, (IMG // s) ** 2) for s in (4, 8, 16)]
TOKENS = 4
DIM = 32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, torch, reps: int = 10, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / reps)
    return statistics.median(out)


def bound(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scaled_err(got, ref):
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-3)


def check_k1(torch, dtype, gen):
    """K1 against its plain version at every main-path decoder shape."""
    from dahitra_tpu_torch.kernels import folded_decoder as fd
    from dahitra_tpu_torch.nn.blocks import TransformerDecoder
    from dahitra_tpu_torch.nn.decoder_vjp import _operands, pack_decoder_params

    dname = str(dtype).split(".")[-1]
    rows = []
    for name, b, n, depth, heads in K1_SHAPES:
        dec = TransformerDecoder(DIM, depth, heads, 64, DIM).cuda()
        x = torch.randn(b, n, DIM, generator=gen).cuda().to(dtype)
        m = torch.randn(b, TOKENS, DIM, generator=gen).cuda().to(dtype)
        with torch.no_grad():
            ops_in = _operands(x, m, pack_decoder_params(dec), depth, heads,
                               dtype)
        got = fd.decoder_stack_fwd(*ops_in, depth, heads, dtype)
        ref = fd.decoder_stack_fwd_plain(*ops_in, depth, heads, dtype)
        torch.cuda.synchronize()
        err, serr = scaled_err(got, ref)
        if not (torch.isfinite(got.float()).all() and serr <= TOL[dname]):
            fail(f"K1 {name} {dname}: scaled error {serr:.3e} > {TOL[dname]}")
        hl = heads * TOKENS
        size = torch.finfo(dtype).bits // 8
        nbytes = (2 * b * n * DIM + sum(t.numel() for t in ops_in[1:5])) * size \
            + ops_in[5].numel() * 4
        # Per row and layer: the four products (2*32*hl twice, 2*32*32
        # twice) plus about 1400 + 5*hl elementwise operations (two
        # LayerNorms, the clamped exp and divide, GELU, bias and residual
        # adds).
        ops = b * n * depth * (4 * DIM * hl + 4 * DIM * DIM + 1400 + 5 * hl)
        bms, by = bound(nbytes, ops, dname)
        rows.append({
            "shape": name, "B": b, "N": n, "depth": depth, "hl": hl,
            "max_abs_err": err, "scaled_err": serr,
            "ms": time_ms(lambda: fd.decoder_stack_fwd(*ops_in, depth, heads,
                                                       dtype), torch),
            "plain_ms": time_ms(lambda: fd.decoder_stack_fwd_plain(
                *ops_in, depth, heads, dtype), torch),
            "bound_ms": bms, "bound_by": by, "library_ms": None})
    return rows


def check_k3(torch, dtype, gen):
    """K3 against its plain version at every main-path tokenizer shape;
    the library yardstick is one scaled_dot_product_attention call with the
    L token-logit columns as queries and the pixels as keys and values."""
    import torch.nn.functional as F

    from dahitra_tpu_torch.kernels import fused_tokenizer as ft

    dname = str(dtype).split(".")[-1]
    rows = []
    for name, b, n in K3_SHAPES:
        x = torch.randn(b, n, DIM, generator=gen).cuda().to(dtype)
        w = (torch.randn(DIM, TOKENS, generator=gen) * DIM ** -0.5).cuda().to(dtype)
        got = ft.semantic_tokenizer(x, w)
        ref = ft.semantic_tokenizer_plain(x, w)
        torch.cuda.synchronize()
        err, serr = scaled_err(got, ref)
        if not (torch.isfinite(got.float()).all() and serr <= TOL[dname]):
            fail(f"K3 {name} {dname}: scaled error {serr:.3e} > {TOL[dname]}")
        q = w.t().unsqueeze(0).expand(b, TOKENS, DIM)
        lib = F.scaled_dot_product_attention(q, x, x, scale=1.0)
        _, lib_err = scaled_err(lib, ref)
        if lib_err > 10 * TOL[dname]:
            fail(f"K3 {name}: library yardstick disagrees ({lib_err:.3e})")
        size = torch.finfo(dtype).bits // 8
        nbytes = (b * n * DIM + DIM * TOKENS + b * TOKENS * DIM) * size
        # logits and pooling products, plus max, exp, sum and scale per
        # logit.
        ops = b * n * (4 * DIM * TOKENS + 5 * TOKENS)
        bms, by = bound(nbytes, ops, dname)
        rows.append({
            "shape": name, "B": b, "N": n, "L": TOKENS,
            "max_abs_err": err, "scaled_err": serr,
            "ms": time_ms(lambda: ft.semantic_tokenizer(x, w), torch),
            "plain_ms": time_ms(lambda: ft.semantic_tokenizer_plain(x, w), torch),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, x, x, scale=1.0), torch)})
    return rows


def summarize(name, source, replaces, dname, rows, launches):
    """One kernel entry: times summed over the kernel's launches in one
    batch-8 forward, errors the worst over those shapes."""
    lib = [r["library_ms"] for r in rows]
    bound_ms = sum(r["bound_ms"] for r in rows)
    by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    return {
        "name": f"{name}[{dname}]", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "scaled_err": max(r["scaled_err"] for r in rows),
        "tolerance": TOL[dname],
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": bound_ms,
        "bound_by": "operations" if by_ops >= bound_ms / 2 else "bytes",
        "library_ms": None if None in lib else sum(lib),
        "per_forward_shapes": rows,
    }


# Kernel-name fragments -> class, first match wins (torch.profiler names).
_CLASSES = (("K1 decoder_stack_fwd", ("decoder_stack_fwd",)),
            ("K3 semantic_tokenizer", ("tokenizer_kernel",)),
            ("convolution (cuDNN)", ("conv", "fprop", "implicit", "fft",
                                     "winograd", "complex")),
            ("matmul (cuBLAS)", ("gemm", "Gemm", "cutlass")),
            ("softmax / layer norm", ("softmax", "norm")))


def profile_forward(torch, state_dict, dtype) -> dict:
    """torch.profiler over five batch-8 forwards of the port's model: device
    time by kernel class, and the device's idle share against the CUDA-event
    time of one forward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dahitra_tpu_torch.core.checkpoint import load_weights
    from dahitra_tpu_torch.data.augment import normalize_images
    from dahitra_tpu_torch.models.registry import define_g

    model = define_g("newUNetTrans", dtype=dtype, img_size=IMG)
    load_weights(model, state_dict)
    model.cuda().eval()
    g = torch.Generator().manual_seed(1)
    a, b = (normalize_images(torch.randint(
        0, 256, (BATCH, IMG, IMG, 3), generator=g, dtype=torch.uint8).cuda(),
        dtype) for _ in range(2))
    reps = 5
    with torch.inference_mode():
        forward_ms = time_ms(lambda: model(a, b), torch, reps=reps, rounds=3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                model(a, b)
            torch.cuda.synchronize()
    # Device-side events only: an operator row (aten::...) repeats the
    # time of the kernels it launched.
    kernels = [(e.key, e.self_device_time_total / reps / 1e3, e.count / reps)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    by_class = {}
    for name, ms, _ in kernels:
        cls = next((c for c, frags in _CLASSES
                    if any(f in name for f in frags)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms
    busy = sum(ms for _, ms, _ in kernels)
    kernels.sort(key=lambda k: -k[1])
    return {"profile": str(dtype).split(".")[-1], "batch": BATCH,
            "forward_ms": forward_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / forward_ms),
            "by_class_ms": by_class,
            "top": [{"kernel": n[:90], "ms": ms, "calls": c}
                    for n, ms, c in kernels[:12]]}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA card")
    try:
        from dahitra_tpu_torch.cli import eval_cd
        from dahitra_tpu_torch.core.checkpoint import save_checkpoint
        from dahitra_tpu_torch.data.synthetic import write_synthetic_levir
        from dahitra_tpu_torch.kernels import _build
        from dahitra_tpu_torch.kernels import folded_decoder as fd
        from dahitra_tpu_torch.kernels import fused_tokenizer as ft
        from dahitra_tpu_torch.models.registry import define_g
        from dahitra_tpu_torch.utils import disable_tf32
    except ImportError as e:
        fail(f"the port's package is missing beside this script ({e})")

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    disable_tf32()

    # 2. build
    t0 = time.time()
    _build.build(_build.sources())
    print(f"build: {_build.sources()} in {time.time() - t0:.1f} s", flush=True)

    # 3. kernels against their plain versions
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(0)
    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        checks[("k1", dname)] = check_k1(torch, dtype, gen)
        checks[("k3", dname)] = check_k3(torch, dtype, gen)
        for key in (("k1", dname), ("k3", dname)):
            for r in checks[key]:
                print(json.dumps({"check": f"{key[0]}[{dname}]", **r}),
                      flush=True)

    # 4. synthetic LEVIR and a seeded checkpoint
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    t0 = time.time()
    write_synthetic_levir(os.path.join(tmp, "data"), n_tiles=4, size=1024,
                          seed=0)
    os.environ["DAHITRA_DATA_ROOT"] = os.path.join(tmp, "data")
    model = define_g("newUNetTrans", img_size=IMG)
    model.init_weights(torch.Generator().manual_seed(0))
    save_checkpoint(os.path.join(tmp, "ckpt", "smoke"), model.state_dict(),
                    best_val_acc=0.0, best_epoch_id=0)
    print(f"setup: synthetic LEVIR + checkpoint in {time.time() - t0:.1f} s",
          flush=True)

    # 5. the main path, fp32 then bf16
    n_forward = 64 // BATCH
    launches = {}
    for flag, dname in (([], "float32"), (["--bf16"], "bfloat16")):
        argv = ["--checkpoint_root", os.path.join(tmp, "ckpt"),
                "--project_name", "smoke", "--data_name", "LEVIR",
                "--split", "test", "--img_size", str(IMG),
                "--batch_size", str(BATCH), "--num_patches", "16",
                "--device", "cuda", *flag]
        torch.cuda.reset_peak_memory_stats()
        fd.launches = 0
        ft.launches = 0
        scores = eval_cd.main(argv)
        torch.cuda.synchronize()
        launches[dname] = {"k1": fd.launches, "k3": ft.launches}
        want = {"k1": 6 * n_forward, "k3": 3 * n_forward}
        if launches[dname] != want:
            fail(f"{dname} launches {launches[dname]} != {want}")
        finite = all(0.0 <= scores[k] <= 1.0 for k in ("acc", "miou", "mf1"))
        if not finite or len(scores.get("per_group", [])) != 16:
            fail(f"{dname} scores out of range or patch blocks missing: "
                 f"{scores}")
        print(json.dumps({"eval": dname, "pairs_per_s": scores["imps"],
                          "peak_mem_gib": torch.cuda.max_memory_allocated()
                          / 2 ** 30, "launches": launches[dname],
                          "scores": {k: scores[k] for k in
                                     ("acc", "miou", "mf1", "F1_1", "iou_1")}}),
              flush=True)

    # 6. the card's forward (kernels) against the plain path on the CPU
    from dahitra_tpu_torch.data.augment import normalize_images
    from dahitra_tpu_torch.data.levir import load_levir_split

    pairs = load_levir_split(os.path.join(tmp, "data", "LEVIR_CD"), "test",
                             IMG, patch=5)
    a_u8 = torch.from_numpy(pairs.a[:2])
    b_u8 = torch.from_numpy(pairs.b[:2])
    with torch.inference_mode():
        ref = model.eval()(normalize_images(a_u8), normalize_images(b_u8))
        cuda_model = model.cuda()
        got = cuda_model(normalize_images(a_u8.cuda()),
                         normalize_images(b_u8.cuda())).cpu()
    _, serr = scaled_err(got, ref)
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(json.dumps({"forward_vs_cpu_plain": {"scaled_err": serr,
                                               "argmax_agreement": agree}}),
          flush=True)
    if not (torch.isfinite(got).all() and serr <= 1e-3 and agree >= 0.999):
        fail(f"card forward disagrees with the CPU plain path: scaled error "
             f"{serr:.3e} (tolerance 1e-3), argmax agreement {agree:.5f}")

    if "--profile" in sys.argv[1:]:
        sd = model.state_dict()
        for dtype in (torch.float32, torch.bfloat16):
            print(json.dumps(profile_forward(torch, sd, dtype)), flush=True)

    kernels = []
    for dname in ("float32", "bfloat16"):
        kernels.append(summarize(
            "decoder_stack_fwd", "dahitra_tpu_torch/csrc/decoder_fwd.cu",
            "dahitra_tpu/pallas/folded_decoder.py:180", dname,
            checks[("k1", dname)], launches[dname]["k1"]))
        kernels.append(summarize(
            "semantic_tokenizer", "dahitra_tpu_torch/csrc/tokenizer.cu",
            "dahitra_tpu/pallas/fused_tokenizer.py:42", dname,
            checks[("k3", dname)], launches[dname]["k3"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
