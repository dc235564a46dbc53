"""Where K8b's, K8w's and the reduction's time goes: K8's backward kernels
and variants of them without one stage, timed on the card.

    python3 scripts_dev/torch_k8b_parts.py [--parent DIR]
                                           [--out FILE]

Compiles `bbx_torch/csrc/evaluator_backward.cu` (with its headers inlined)
as it is and edited into variants into `build/k8b_parts/`, then times
`bbx_evaluator_grad_tiles` (the weight layout and K8b),
`bbx_evaluator_grad_dense0` (K8w) and `bbx_evaluator_grad_reduce` (the
reduction, after the same build's K8b and K8w) at run9 widths in bf16 at
B = 512 and 2048 lanes between CUDA events, in turns (the list, then the
list reversed).  Each K8b variant drops one stage of the backward walk --
da2's product, dW2's product, da1's convolution, conv1's weight gradient,
x0's stores -- or all four products at once, or the whole walk (what is
left is the recompute, the epilogues and the record), or one of the
recompute's products (conv2's, dense0's); a stage's time is
about the full kernel's less the variant's without it (their gradients
are wrong by design).  The K8w variants drop its products (the bulk
copies' ring alone) or dz0's copies, or hold 8 stages or 8 consumer warps
in place of 5 and 16.  `k8b_da1_shared` builds K8b as if shared memory
were short, with da1's row over da2t's (the layout of the width limits).
`reduce_fused` launches the reduction's dctx blocks with its sums' blocks,
in one launch in place of two.  With `--parent DIR` (a checkout of another
commit, e.g. unpacked from `git archive`) its `evaluator_backward.cu` joins
the list as the variant `parent`, its three kernels timed; first, on
`chip_smoke.py`'s K8b cases (run9 widths at 2048 and 512 lanes, the tiny,
ragged and limit widths, bf16 and float32, on its mid-game boards, network
and upstream gradient), every output of the parent's three kernels is
compared with this tree's, bit for bit: the block records, the tiles' dz0
sums, K8w's partials, x0 and dz0 (as `_GradWork.x0_matrix` /
`dz0_matrix` read them), dctx and the eight gradients, with the count of
differing elements of each and each side's plan; this tree's run twice
gives the same bits too.  The edits are exact strings of this tree's
source; the script stops when one is missing.  Needs a CUDA card.
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

# Each variant: the kernel it times and the (string, replacement) pairs
# that make it from this tree's source.
STAGES = {
    "da2": ("k8b", [("tile_k16<MTB, NTB, false, S, true>(cb, a, b, MTB, ntb);", ";")]),
    "dw2": ("k8b", [("tile_k16<2, NTW, true, S, true>(acc2, a, b, mt2, ntw);", ";")]),
    "da1": ("k8b", [
        ("ev_conv3_row<S, T, float, false, true>(cd, s_da2, c2p, e.cg2, s_w2t, e.cg1,\n"
         "                                                           s_zero, y);",
         "zero(cd);")]),
    "dw1": ("k8b", [("tile_k16<1, 3, true, S, true>(acc1, a, b, mi < e.c1m / 16 ? 1 : 0, 3);", ";")]),
    "x0_stores": ("k8b", [("store8(xt + evb_at<S, T>(col, 8 * q), v);", ";")]),
    # The recompute's products (evb_forward_tile).
    "fwd_conv2": ("k8b", [(
        "ev_conv3_row<S, T, Acc, false, true>(c, s_ring, c1p, e.cg1, s_w2, e.nt2, s_zero, r);",
        "zero(c);")]),
    "fwd_dense0": ("k8b", [("tile_k16<T / 16, NT0, false, S, true>(acc, a, b, T / 16, nt0w);",
                            ";")]),
    "walk": ("k8b", [("for (int r = 7; r >= -1; --r) {", "for (int r = 7; r >= 8; --r) {")]),
    "k8w_products": ("k8w", [("tile_k16<EV_MAX_H / 32, NQ, true, S>(acc, a, b, mtw, ntw);", ";")]),
    "k8w_dz0": ("k8w", [
        ("bbx_mbar_expect_tx(full + s, bz + bx);", "bbx_mbar_expect_tx(full + s, bx);"),
        ("bbx_bulk_copy(st, dz0g + tile * e.hk * T, bz, full + s);", ";")]),
}
# Whole variants, not a stage dropped: the kernel they time and their edits.
OTHERS = {
    "k8w_8_stages": ("k8w", [("#define EVB_K8W_STAGES 5", "#define EVB_K8W_STAGES 8")]),
    "k8w_8_consumers": ("k8w", [("#define EVB_K8W_CWARPS 16 ", "#define EVB_K8W_CWARPS 8 ")]),
    # K8b's layout of the width limits at run9 widths: da1's row over da2t's.
    "k8b_da1_shared": ("k8b", [("#define EVB_SMEM_LIMIT 232448", "#define EVB_SMEM_LIMIT 1")]),
    "reduce_fused": ("reduce", [(
        """    BBX_LAUNCH(kernel, g.rec + g.w0, 256, stream,
               (const float*)part, p.blocks, rec, (const float*)partw, p.splits,
               (const float*)stile, (const S*)layout, e, (float*)grads, (S*)dctx, b * 3, g, 0);
    BBX_LAUNCH(kernel, g.ctx, 256, stream,
               (const float*)part, p.blocks, rec, (const float*)partw, p.splits,
               (const float*)stile, (const S*)layout, e, (float*)grads, (S*)dctx, b * 3, g,
               g.rec + g.w0);""",
        """    BBX_LAUNCH(kernel, g.rec + g.w0 + g.ctx, 256, stream,
               (const float*)part, p.blocks, rec, (const float*)partw, p.splits,
               (const float*)stile, (const S*)layout, e, (float*)grads, (S*)dctx, b * 3, g, 0);""")]),
}


def replaced(text, name, pairs):
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def inlined(csrc):
    """`evaluator_backward.cu` of the source directory `csrc` with the
    headers of its own that it includes inlined."""
    with open(os.path.join(csrc, "evaluator_backward.cu")) as f:
        src = f.read()
    for header in sorted(os.listdir(csrc)):
        if header.endswith(".cuh") and f'#include "{header}"\n' in src:
            with open(os.path.join(csrc, header)) as f:
                text = f.read().replace("#pragma once\n", "")
            src = src.replace(f'#include "{header}"\n', text)
    return src


def variants(parent=None):
    src = inlined(build.CSRC)
    out = {"full": src}
    if parent:
        out["parent"] = inlined(os.path.join(parent, "bbx_torch", "csrc"))
    for name, (_, pairs) in STAGES.items():
        out[f"no_{name}"] = replaced(src, name, pairs)
    products = src
    for name in ("da2", "dw2", "da1", "dw1"):
        products = replaced(products, name, STAGES[name][1])
    out["no_products"] = products
    for name, (_, pairs) in OTHERS.items():
        out[name] = replaced(src, name, pairs)
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
        ptxas[name] = [line.strip() for line in log.splitlines()
                       if "registers" in line or "spill" in line or "Compiling entry" in line]
        lib = ctypes.CDLL(os.path.join(work, f"lib{name}.so"))
        pair = {}
        for kernel, entry in (("k8b", "evaluator_grad_tiles"), ("k8w", "evaluator_grad_dense0"),
                              ("reduce", "evaluator_grad_reduce"),
                              ("sizes", "evaluator_grad_sizes")):
            fn = getattr(lib, build.SIGNATURES[entry][1])
            fn.argtypes, fn.restype = build.SIGNATURES[entry][2], ctypes.c_int
            pair[kernel] = fn
        fns[name] = pair
    return fns, ptxas


def run_side(pair, ev, planes, feats, ctx, ds, dt):
    """K8b, K8w and the reduction of one build (`pair`'s entry points) on
    buffers sized by its own `bbx_evaluator_grad_sizes`: every output,
    and the plan it reports."""
    params = [p.detach().float().contiguous() for p in ev.parameters()]
    b, d = planes.shape[0], ctx.shape[-1]
    c1, c2 = ev.convs[0].out_channels, ev.convs[1].out_channels
    h = ev.dense0.out_features
    widths = (b, c1, c2, h, d, dt.itemsize)
    sizes = torch.zeros(32, dtype=torch.int64)
    build.check("sizes", pair["sizes"](*widths, sizes.data_ptr()))
    n = sizes.tolist()
    dev = planes.device
    f32 = torch.float32
    layout = torch.empty(n[0], dtype=dt, device=dev)
    x0 = torch.empty(n[1], dtype=dt, device=dev)
    dz0 = torch.empty(n[2], dtype=dt, device=dev)
    stile = torch.empty(n[3], dtype=f32, device=dev)
    part = torch.empty(n[4], dtype=f32, device=dev)
    partw = torch.empty(n[5], dtype=f32, device=dev)
    flat = torch.zeros(n[6], dtype=f32, device=dev)
    dctx = torch.zeros(ctx.shape, dtype=dt, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    build.check("k8b", pair["k8b"](planes.data_ptr(), feats.data_ptr(), ctx.data_ptr(),
                                   ds.data_ptr(), *(p.data_ptr() for p in params),
                                   layout.data_ptr(), x0.data_ptr(), dz0.data_ptr(),
                                   stile.data_ptr(), part.data_ptr(), *widths, stream))
    build.check("k8w", pair["k8w"](x0.data_ptr(), dz0.data_ptr(), partw.data_ptr(), *widths,
                                   stream))
    build.check("reduce", pair["reduce"](part.data_ptr(), partw.data_ptr(), stile.data_ptr(),
                                         layout.data_ptr(), flat.data_ptr(), dctx.data_ptr(),
                                         *widths, stream))
    torch.cuda.synchronize()
    m = b * 192
    # The records to their size: the stride's padding is never written.
    size = 19 * c1 + c2 * (9 * c1 + 1) + 2 * h + 1
    out = {"records": part.view(n[9], -1)[:, :size], "tile_dz0_sums": stile, "k8w_partials": partw,
           "x0": A.grad_tile_matrix(x0, m), "dz0": A.grad_tile_matrix(dz0, m), "dctx": dctx}
    names = [name for name, _ in ev.named_parameters()]
    for name, g in zip(names, flat.split([p.numel() for p in params])):
        out[name] = g
    plan = dict(zip(A._GradWork.PLAN, n[7:7 + len(A._GradWork.PLAN)]))
    return {k: v.clone() for k, v in out.items()}, plan


def differing(a, b) -> int:
    """Elements whose bits differ (all of them where the shapes do)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel())
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return int((a.view(ints) != b.view(ints)).sum())


def compare_parent(fns):
    """Every output of the parent's K8b, K8w and reduction against this
    tree's on `chip_smoke.py`'s K8b cases, and this tree's twice."""
    import chip_smoke as C

    dev = torch.device("cuda")
    _, obs, _, _ = C.midgame_boards(dev)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {"2048_bfloat16": (C.RUN9_EVAL_WIDTHS, 2048, bf16),
             "512_bfloat16": (C.RUN9_EVAL_WIDTHS, 512, bf16),
             "512_float32": (C.RUN9_EVAL_WIDTHS, 512, f32),
             "tiny_512_bfloat16": (((4, 4), 8, 6), 512, bf16),
             "tiny_512_float32": (((4, 4), 8, 6), 512, f32),
             "ragged_3_bfloat16": (((5, 12), 20, 7), 3, bf16),
             "ragged_3_float32": (((5, 12), 20, 7), 3, f32),
             "limits_512_bfloat16": (C.K8_LIMIT_WIDTHS, 512, bf16),
             "limits_512_float32": (C.K8_LIMIT_WIDTHS, 512, f32)}
    rows = {}
    for case, (widths, b, dt) in cases.items():
        net = C.k8_net(dev, widths, dt)
        board, pieces = obs["board"][:b].float().contiguous(), obs["pieces"][:b].contiguous()
        g = torch.Generator(device=dev).manual_seed(C.SEED + b)
        with torch.no_grad():
            planes, feats, ctx = net.afterstates(board, pieces)
            ds = torch.randn(b * 192, generator=g, device=dev).to(dt)
            got, plan = run_side(fns["full"], net.evaluator, planes, feats, ctx, ds, dt)
            again, _ = run_side(fns["full"], net.evaluator, planes, feats, ctx, ds, dt)
            want, plan_parent = run_side(fns["parent"], net.evaluator, planes, feats, ctx, ds,
                                         dt)
        row = {"differing": {k: differing(got[k], want[k]) for k in got},
               "elements": {k: got[k].numel() for k in got},
               "differing_run_to_run": sum(differing(got[k], again[k]) for k in got),
               "plan": plan, "plan_parent": plan_parent}
        row["bit_equal"] = (not any(row["differing"].values())
                            and row["differing_run_to_run"] == 0)
        rows[case] = row
        print(json.dumps({"case": case, "bit_equal": row["bit_equal"],
                          "differing": sum(row["differing"].values()),
                          "differing_run_to_run": row["differing_run_to_run"],
                          "plan": plan, "plan_parent": plan_parent}), flush=True)
    return rows


def timed(call, reps=10):
    for _ in range(2):
        call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a checkout of another commit")
    ap.add_argument("--out", default=None, help="JSON results path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    fns, ptxas = compile_all(variants(args.parent))
    compared = compare_parent(fns) if args.parent else None
    # (variant, kernel timed): the full and the parent's builds time all three.
    order = []
    for name in fns:
        stage = name[3:] if name.startswith("no_") else None
        kinds = (["k8b", "k8w", "reduce"] if name in ("full", "parent")
                 else [OTHERS[name][0]] if name in OTHERS
                 else [STAGES[stage][0]] if stage in STAGES else ["k8b"])
        order += [(name, kind) for kind in kinds]
    dev = torch.device("cuda")
    dt = torch.bfloat16
    net = A.AfterstateNetwork(compute_dtype=dt, generator=torch.Generator().manual_seed(1))
    ev = net.to(dev).evaluator
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for b in (512, 2048):
        obs = observe(TState.reset(b, TState.make_generator(3, dev), dev))
        g = torch.Generator(device=dev).manual_seed(b)
        with torch.no_grad():
            planes, feats, ctx = net.afterstates(obs["board"].float().contiguous(),
                                                 obs["pieces"].contiguous())
            ds = torch.randn(b * 192, generator=g, device=dev).to(dt)
            w = A._GradWork(ev, planes, feats, ctx, ds, dt)
            # A variant plans its own grids (its registers set its resident
            # blocks): the records and partials as large as any needs.
            n_part = n_partw = 0
            for pair in fns.values():
                sizes = torch.zeros(32, dtype=torch.int64)
                build.check("sizes", pair["sizes"](*w.widths, sizes.data_ptr()))
                n_part, n_partw = max(n_part, int(sizes[4])), max(n_partw, int(sizes[5]))
            w.part = torch.empty(n_part, dtype=torch.float32, device=dev)
            w.partw = torch.empty(n_partw, dtype=torch.float32, device=dev)
        calls = {}
        for name, pair in fns.items():
            def k8b(fn=pair["k8b"], name=name):
                build.check(name, fn(planes.data_ptr(), feats.data_ptr(), ctx.data_ptr(),
                                     ds.data_ptr(), *(p.data_ptr() for p in w.params),
                                     w.layout.data_ptr(), w.x0.data_ptr(), w.dz0.data_ptr(),
                                     w.stile.data_ptr(), w.part.data_ptr(), *w.widths, stream))

            def k8w(fn=pair["k8w"], name=name):
                build.check(name, fn(w.x0.data_ptr(), w.dz0.data_ptr(), w.partw.data_ptr(),
                                     *w.widths, stream))

            def reduce(fn=pair["reduce"], name=name):
                build.check(name, fn(w.part.data_ptr(), w.partw.data_ptr(), w.stile.data_ptr(),
                                     w.layout.data_ptr(), w.flat.data_ptr(), w.dctx.data_ptr(),
                                     *w.widths, stream))

            calls[name] = {"k8b": k8b, "k8w": k8w, "reduce": reduce}
        for name, kind in order + order[::-1]:
            if kind == "k8w":
                calls["full"]["k8b"]()  # K8w reads the x0 and dz0 the full K8b writes
            if kind == "reduce":
                # The reduction reads the records, partials and layout its
                # own build's K8b and K8w write.
                own = "parent" if name == "parent" else "full"
                calls[own]["k8b"]()
                calls[own]["k8w"]()
            row = {"lanes": b, "variant": name, "kernel": kind,
                   "ms": timed(calls[name][kind])}
            rows.append(row)
            print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    for name, lines in ptxas.items():
        print(name, lines)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi.strip(), "ptxas": ptxas, "rows": rows,
                       "parent_compare": compared}, f, indent=2)
    return 0 if compared is None or all(r["bit_equal"] for r in compared.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
