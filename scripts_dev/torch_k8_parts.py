"""Where K8's time goes: the evaluator kernel and variants of it, timed on
the card.

    python3 scripts_dev/torch_k8_parts.py [--variants parts|knobs|tile]
                                          [--out chiprun_out/k8_parts.json]

Compiles `bbx_torch/csrc/evaluator.cu` (with `evaluator.cuh`, which holds
the tile's forward, inlined) as it is and edited into variants into
`build/k8_parts/`, then times each at run9 widths in bf16 at B = 512
and 2048 lanes between CUDA events, in turns (the list, then the list
reversed).  The variant sets:
  parts  the products of conv1, conv2, dense0, or all three removed (and,
         with all three removed, also without the convolutions' epilogue
         stores or the context's part of dense0): a stage's time is about
         the full kernel's less the variant's without it; those variants'
         scores are wrong by design;
  knobs  `__launch_bounds__(256, 2)`, conv2's channel-group loop unrolled,
         dense0's k loop unrolled 4 or 1 times (2 in the source);
  tile   a bf16 tile of 64 afterstates (16 warps) against 32, with and
         without dense0's products.
Needs a CUDA card.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from bbx_torch.engine import state as TState  # noqa: E402
from bbx_torch.engine.step import observe  # noqa: E402
from bbx_torch.models import afterstate as A  # noqa: E402
from bbx_torch.ops import build  # noqa: E402

# Each stage's call of the product, as it stands in evaluator.cuh.
PRODUCTS = {
    "conv1": "tile_k16<2, 4, false, S>(c, a, b, e.c1m / 16, 4);",
    "conv2": "tile_k16<2, 4, true, S>(c, a, b, 2, nt);",
    "dense0": "tile_k16<T / 16, NT0, false, S>(acc, a, b, T / 16, nt0w);",
}
EPILOGUES = [
    ("put(ch, x, 4 * warp + j, relu_to<S>(c[i][j][k] + bb));", ";"),
    ("store2(o, relu_to<S>(c[i][j][0] + b0), relu_to<S>(c[i][j][1] + b1));", ";"),
    ("store2(o + sstr, relu_to<S>(c[i][j][2] + b0), relu_to<S>(c[i][j][3] + b1));", ";"),
]
CONTEXT = [("        for (; dd + 4 <= e.d; dd += 4) {", "        for (; dd + 4 <= 0; dd += 4) {"),
           ("        for (; dd < e.d; ++dd) s4[0]", "        for (; dd < 0; ++dd) s4[0]")]


def replaced(text, pairs):
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"evaluator.cu(h) no longer holds {old!r}: update this script")
        text = text.replace(old, new)
    return text


def variants(which):
    with open(os.path.join(build.CSRC, "evaluator.cu")) as f:
        src = f.read()
    with open(os.path.join(build.CSRC, "evaluator.cuh")) as f:
        header = f.read().replace("#pragma once\n", "")
    src = replaced(src, [('#include "evaluator.cuh"\n', header)])
    out = {"full": src}
    if which == "parts":
        for name, call in PRODUCTS.items():
            out[f"no_{name}"] = replaced(src, [(call, "")])
        bare = replaced(src, [(call, "") for call in PRODUCTS.values()])
        out["no_products"] = bare
        out["no_products_no_epilogues"] = replaced(bare, EPILOGUES)
        out["no_products_no_context"] = replaced(bare, CONTEXT)
    elif which == "knobs":
        dense0_loop = "#pragma unroll 2\n        for (int s = kq; s < e.c2p / 2; s += 2) {"
        out["launch_bounds_2"] = replaced(src, [(
            "__launch_bounds__(8 * T)\nevaluator_kernel(",
            "__launch_bounds__(8 * T, 2)\nevaluator_kernel(")])
        out["conv2_groups_unrolled"] = replaced(src, [(
            "        for (int q = 0; q < cg; ++q) {",
            "#pragma unroll 4\n        for (int q = 0; q < cg; ++q) {")])
        out["dense0_unroll_4"] = replaced(src, [(dense0_loop, dense0_loop.replace("2", "4", 1))])
        out["dense0_unroll_1"] = replaced(src, [(dense0_loop, dense0_loop.replace("2", "1", 1))])
    else:
        t64 = replaced(src, [("evaluator_launch<unsigned short, 32>(",
                              "evaluator_launch<unsigned short, 64>(")])
        out["no_dense0"] = replaced(src, [(PRODUCTS["dense0"], "")])
        out["tile_64"] = t64
        out["tile_64_no_dense0"] = replaced(t64, [(PRODUCTS["dense0"], "")])
    return out


def compile_all(sources):
    work = os.path.join(ROOT, "build", "k8_parts")
    os.makedirs(work, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        path = os.path.join(work, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC,
               "-o", os.path.join(work, f"lib{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} does not compile:\n{log}")
        ptxas[name] = [line.strip() for line in log.splitlines() if "registers" in line]
        fn = ctypes.CDLL(os.path.join(work, f"lib{name}.so")).bbx_evaluator
        fn.argtypes, fn.restype = build.SIGNATURES["evaluator"][2], ctypes.c_int
        fns[name] = fn
    return fns, ptxas


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", choices=("parts", "knobs", "tile"), default="parts")
    ap.add_argument("--out", default=None, help="JSON results path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    fns, ptxas = compile_all(variants(args.variants))
    dev = torch.device("cuda")
    dt = torch.bfloat16
    net = A.AfterstateNetwork(compute_dtype=dt, generator=torch.Generator().manual_seed(1))
    net = net.to(dev)
    ev = net.evaluator
    params = (ev.convs[0].weight, ev.convs[0].bias, ev.convs[1].weight, ev.convs[1].bias,
              ev.dense0.weight, ev.dense0.bias, ev.dense1.weight, ev.dense1.bias)
    widths = (24, 24, 96, 32)
    layout = torch.empty(build.function("evaluator_layout_size")(*widths), dtype=dt, device=dev)
    rows = []
    for b in (512, 2048):
        obs = observe(TState.reset(b, TState.make_generator(3, dev), dev))
        with torch.no_grad():
            planes, feats, ctx = net.afterstates(obs["board"].float().contiguous(),
                                                 obs["pieces"].contiguous())
            want = A.evaluator_scores_plain(ev, planes, feats, ctx, dt)
            for name in list(fns) + list(fns)[::-1]:
                scores = torch.empty(b * 192, dtype=dt, device=dev)

                def call(fn=fns[name], scores=scores):
                    err = fn(planes.data_ptr(), feats.data_ptr(), ctx.data_ptr(),
                             *(p.data_ptr() for p in params), layout.data_ptr(),
                             scores.data_ptr(), b, *widths, 2,
                             torch.cuda.current_stream().cuda_stream)
                    build.check(name, err)

                for _ in range(3):
                    call()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    call()
                end.record()
                end.synchronize()
                row = {"lanes": b, "variant": name, "ms": start.elapsed_time(end) / 20,
                       "max_abs_err": float((scores.double() - want.double()).abs().max())}
                rows.append(row)
                print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi.strip(), "ptxas": ptxas, "rows": rows}, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
