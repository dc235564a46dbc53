"""Where K8b's time goes: the backward's per-tile kernel and variants of it
without one stage, timed on the card.

    python3 scripts_dev/torch_k8b_parts.py [--out chiprun_out/k8b_parts.json]

Compiles `bbx_torch/csrc/evaluator_backward.cu` (with `evaluator.cuh`
inlined) as it is and edited into variants into `build/k8b_parts/`, then
times `bbx_evaluator_grad_tiles` (the weight layout and K8b) at run9 widths
in bf16 at B = 512 and 2048 lanes between CUDA events, in turns (the list,
then the list reversed).  Each variant drops one stage of the backward
walk -- da2's product, dW2's product, da1's convolution, conv1's weight
gradient, x0's stores -- or all four products at once; a stage's time is
about the full kernel's less the variant's without it (their gradients
are wrong by design).  The recompute's time is K8's forward's
(`torch_k8_parts.py`).  Needs a CUDA card.
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

# Each stage, as it stands in evaluator_backward.cu, and what replaces it.
STAGES = {
    "da2": [("tile_k16<MTB, NTB, false, S>(cb, a, b, MTB, ntb);", ";")],
    "dw2": [("tile_k16<2, NTW, true, S>(acc2, a, b, mt2, ntw);", ";")],
    "da1": [("if (y <= 7) ev_conv3_row<S, T>(cd, s_da2, c2p, e.cg2, s_w, e.cg1, s_zero, y);",
             "zero(cd);")],
    "dw1": [("for (int a = 0; a < T; ++a) {\n                            const float d",
             "for (int a = 0; a < 0; ++a) {\n                            const float d")],
    "x0_stores": [("xt[(size_t)(r * 8 * c2p + k) * T + a] = v;", ";")],
}


def replaced(text, pairs):
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"evaluator_backward.cu no longer holds {old!r}: update this script")
        text = text.replace(old, new)
    return text


def variants():
    with open(os.path.join(build.CSRC, "evaluator_backward.cu")) as f:
        src = f.read()
    with open(os.path.join(build.CSRC, "evaluator.cuh")) as f:
        header = f.read().replace("#pragma once\n", "")
    src = replaced(src, [('#include "evaluator.cuh"\n', header)])
    out = {"full": src}
    for name, pairs in STAGES.items():
        out[f"no_{name}"] = replaced(src, pairs)
    out["no_products"] = replaced(src, STAGES["da2"] + STAGES["dw2"] + STAGES["da1"]
                                  + STAGES["dw1"])
    return out


def compile_all(sources):
    work = os.path.join(ROOT, "build", "k8b_parts")
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
        fn = ctypes.CDLL(os.path.join(work, f"lib{name}.so")).bbx_evaluator_grad_tiles
        fn.argtypes, fn.restype = build.SIGNATURES["evaluator_grad_tiles"][2], ctypes.c_int
        fns[name] = fn
    return fns, ptxas


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON results path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    fns, ptxas = compile_all(variants())
    dev = torch.device("cuda")
    dt = torch.bfloat16
    net = A.AfterstateNetwork(compute_dtype=dt, generator=torch.Generator().manual_seed(1))
    ev = net.to(dev).evaluator
    rows = []
    for b in (512, 2048):
        obs = observe(TState.reset(b, TState.make_generator(3, dev), dev))
        g = torch.Generator(device=dev).manual_seed(b)
        with torch.no_grad():
            planes, feats, ctx = net.afterstates(obs["board"].float().contiguous(),
                                                 obs["pieces"].contiguous())
            ds = torch.randn(b * 192, generator=g, device=dev).to(dt)
            w = A._GradWork(ev, planes, feats, ctx, ds, dt)
        for name in list(fns) + list(fns)[::-1]:
            def call(fn=fns[name]):
                err = fn(planes.data_ptr(), feats.data_ptr(), ctx.data_ptr(), ds.data_ptr(),
                         *(p.data_ptr() for p in w.params), w.layout.data_ptr(),
                         w.x0.data_ptr(), w.dz0.data_ptr(), w.stile.data_ptr(),
                         w.part.data_ptr(), *w.widths, torch.cuda.current_stream().cuda_stream)
                build.check(name, err)

            for _ in range(2):
                call()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            end.synchronize()
            row = {"lanes": b, "variant": name, "ms": start.elapsed_time(end) / 10}
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
