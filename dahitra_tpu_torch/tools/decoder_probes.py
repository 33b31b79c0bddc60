"""Two measurements behind the decoder kernels' design notes, on one card.

    python -m dahitra_tpu_torch.tools.decoder_probes cta-rows [--warps 4]
    python -m dahitra_tpu_torch.tools.decoder_probes sass-diff OTHER_CHECKOUT [--out DIR]

``cta-rows`` builds ``csrc/decoder_fwd.cu`` once more with ``WARPS`` set to
``--warps`` (16 rows per warp, so the CTA's rows change) and times it against
the source's own build behind queued work, both instances, at every phase-3
decoder shape of ``chip_smoke.py``, checking that both give the same bits.
``sass-diff`` builds ``csrc/decoder_fwd.cu`` (K1 and K1-save),
``csrc/decoder_bwd.cu`` (K2) and ``csrc/fused_decoder.cu`` (K4) here and in
another checkout and, per kernel instance of the other checkout, counts the
lines in which its ``cuobjdump -sass`` differs from the same instance here
(a line diff of the instructions and their encodings, control bits
included, the addresses aside; ``--out`` writes each instance's diff to a
file).
Instances are matched by name, the anonymous-namespace hash aside, with a
last template arguments ``false`` (the ``PAD`` and ``WIDE`` flags of the
row kernels) and then an ``mlp_dim`` template argument of 32 read as their
absence, so a checkout that predates any of these parameters compares with
the instances that have none; instances that exist only here are listed as new. One JSON
line each.
"""
from __future__ import annotations

import argparse
import ctypes
import difflib
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from dahitra_tpu_torch.kernels import _build
from dahitra_tpu_torch.kernels import folded_decoder as fd

_ROOT = Path(__file__).resolve().parents[2]


def _nvcc(src, out, *extra):
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o", str(out),
                    str(src)], check=True)


def cta_rows(warps: int) -> None:
    sys.path.insert(0, str(_ROOT))
    import chip_smoke as cs

    src = (_build._CSRC / "decoder_fwd.cu").read_text()
    own = int(re.search(r"constexpr int WARPS = (\d+);", src).group(1))
    tmp = Path(tempfile.mkdtemp(prefix="cta_rows_"))
    (tmp / "decoder_fwd.cu").write_text(
        src.replace(f"constexpr int WARPS = {own};", f"constexpr int WARPS = {warps};"))
    _nvcc(tmp / "decoder_fwd.cu", tmp / "variant.so", "-I", str(_build._CSRC))
    lib = ctypes.CDLL(str(tmp / "variant.so"))
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        fn = getattr(lib, f"decoder_stack_fwd_{fd._DTYPES[dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        for name, b, n, depth, heads in cs.K1_SHAPES + [cs.K1_SHAPE_512]:
            ops, _, _ = cs._decoder_operands(torch, dtype, gen, b, n, depth, heads)
            hl = ops[1].shape[-1]
            y = torch.empty_like(ops[0])

            def variant():
                _build.check(fn(*[t.data_ptr() for t in ops], None, y.data_ptr(), b, n,
                                depth, hl, hl // heads, hl // heads, 32,
                                torch.cuda.current_stream().cuda_stream), "variant")

            def source():
                return fd.decoder_stack_fwd(*ops, depth, heads, dtype)

            variant()
            same = torch.equal(source(), y)
            # source, variant, variant, source
            t = [cs.time_ms(f, torch, queued=True, **cs._reps(n))
                 for f in (source, variant, variant, source)]
            print(json.dumps({"cta_rows": str(dtype).split(".")[-1], "shape": name,
                              "same_bits": same,
                              f"ms_{16 * own}_rows": (t[0] + t[3]) / 2,
                              f"ms_{16 * warps}_rows": (t[1] + t[2]) / 2}), flush=True)


def _functions(dump: str, source: str) -> dict:
    """The SASS lines of each kernel in a ``cuobjdump -sass`` dump (the
    instructions with their encodings, control bits included; addresses cut
    off), keyed by its mangled name with the
    anonymous-namespace hash replaced, the last template arguments ``false``
    (``Lb0E`` before the template's close) and then an ``mlp_dim`` template
    argument of 32 (``Li32E`` there) dropped, and the parameter list cut
    off."""
    dump = re.sub(rf"_GLOBAL__N__[0-9a-f]+_[0-9]+_{source}_cu_[0-9a-f]+", "ANON", dump)
    out, key = {}, None
    for line in dump.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            key = re.sub(r"(?:Lb0E)+(?=EEv)", "", func.group(1))
            key = re.sub(r"Li32E(?=EEv)", "", key).split("Ev", 1)[0]
            out[key] = []
        elif key is not None:
            ins = " ".join(re.sub(r"^\s*/\*[0-9a-f]+\*/", "", line).split())
            if ins:
                out[key].append(ins)
    return out


def sass_diff(other: str, out_dir=None) -> None:
    tmp = Path(tempfile.mkdtemp(prefix="sass_diff_"))
    for source in ("decoder_fwd", "decoder_bwd", "fused_decoder"):
        funcs = []
        for tag, root in (("here", _ROOT), ("other", Path(other))):
            out = tmp / f"{source}_{tag}.so"
            _nvcc(root / "dahitra_tpu_torch" / "csrc" / f"{source}.cu", out)
            dump = subprocess.run(
                [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
                 str(out)], capture_output=True, text=True, check=True).stdout
            funcs.append(_functions(dump, source))
        here, there = funcs
        per = {}
        for name, lines in there.items():
            mine = here.get(name)
            if mine is None:
                per[name] = None
                continue
            diff = [d for d in difflib.unified_diff(lines, mine, "other", "here",
                                                    n=2, lineterm="")]
            per[name] = sum(1 for d in diff if d[:1] in "+-"
                            and not d.startswith(("+++", "---")))
            if out_dir and diff:
                Path(out_dir).mkdir(parents=True, exist_ok=True)
                (Path(out_dir) / f"{name[-60:]}.diff").write_text("\n".join(diff))
        print(json.dumps({"sass_diff": f"{source}.cu",
                          "lines": sum(len(v) for v in there.values()),
                          "differing_lines": sum(v or 0 for v in per.values()),
                          "per_instance": per,
                          "missing_here": [k for k, v in per.items() if v is None],
                          "new_here": sorted(set(here) - set(there))}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("cta-rows").add_argument("--warps", type=int, default=4)
    sd = sub.add_parser("sass-diff")
    sd.add_argument("other")
    sd.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("decoder_probes: needs a CUDA card")
    if args.cmd == "cta-rows":
        cta_rows(args.warps)
    else:
        sass_diff(args.other, args.out)


if __name__ == "__main__":
    main()
