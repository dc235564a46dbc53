"""K5 (GAE) and K9 (the engine path's sampler) against another commit's,
timed on the card in turns.

    python3 scripts_dev/torch_k5_k9_parts.py [--parent DIR] [--out FILE]

Compiles this tree's `bbx_torch/csrc/gae.cu` and `sample.cu`, variants of
them edited by exact strings, and with `--parent DIR` (a checkout of
another commit, e.g. unpacked from `git archive`) that commit's two
sources, into `build/k5_k9_parts/`, each with its ptxas registers and
spills.  Then each variant runs at K5's [128, 512] (run9), [128, 64]
(default.yaml) and [128, 4096] (tpu.yaml) and K9's 16,384 and 512 lanes, in
turns (the list, then the list reversed): its output against the plain
version (bit for bit), its time between CUDA events over back-to-back
calls (`ms`) and its kernel's device time by `torch.profiler`
(`device_ms`).  The variants:
  k5_envs_4, k5_envs_16   K5 with 4 or 16 envs a block (8 in the source);
  k5_threads_256, k5_threads_1024  K5's threads a block (512);
  k5_batch_1, k5_batch_8  K5's chain with its operands loaded 1 or 8 steps
                          ahead (4);
  k5_registers_free       K5 without its cap of 32 registers a thread;
  k5_no_chain, k5_no_loads, k5_no_stores  K5 without the chain's
                          arithmetic, the loads, or the stores; k5_empty,
                          returning at once (results wrong by design);
  k9_lanes_16, k9_lanes_32  K9 with 16 or 32 lanes a warp (8);
  k9_warps_1, k9_warps_2, k9_warps_8  K9 with 1, 2 or 8 warps a block (4).
The script stops when an edit's string is gone from the source.  Needs a
CUDA card.
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

from bbx_torch.agent import ppo as P  # noqa: E402
from bbx_torch.env import vector as V  # noqa: E402
from bbx_torch.ops import build  # noqa: E402

GAE_SHAPES = ((128, 512), (128, 64), (128, 4096))
SAMPLE_LANES = (16384, 512)
# Stages taken out (wrong results by design): the chain's arithmetic, the
# loads of (1), the stores of (3); and the kernel returning at once (a
# launch of the same grid).
NO_CHAIN = ("adv_next = __fadd_rn(d[q], __fmul_rn(c[q], adv_next));", "adv_next = d[q];")
NO_LOADS = ("""                r[j] = rewards[i];
                v[j] = values[i];
                v_next[j] = t + 1 < t_len ? values[i + n] : last_value[env];
                done[j] = dones[i];""", """                r[j] = v[j] = v_next[j] = (float)i;
                done[j] = i & 1;""")
NO_STORES = ("""                adv[i] = a;
                ret[i] = __fadd_rn(a, v[j]);""", """                if (a == 1.5f) ret[i] = v[j];""")
EMPTY = ("    float adv_next = 0.0f;", "    if (t_len > 0) return;\n    float adv_next = 0.0f;")

# K5 without its register cap (four blocks of 512 threads an SM).
REGISTERS_FREE = ("__launch_bounds__(GAE_THREADS, 2048 / GAE_THREADS)\n",
                  "__launch_bounds__(GAE_THREADS)\n")

def _set(name, value, default):
    return (f"#define {name} {default}", f"#define {name} {value}")


# Each variant: its kernel ("gae" or "sample") and its edits of this tree's source.
VARIANTS = {
    **{f"k5_envs_{v}": ("gae", [_set("GAE_ENVS", v, 8)]) for v in (4, 16)},
    **{f"k5_threads_{v}": ("gae", [_set("GAE_THREADS", v, 512)]) for v in (256, 1024)},
    **{f"k5_batch_{v}": ("gae", [_set("GAE_BATCH", f"{v} ", "4 ")]) for v in (1, 8)},
    "k5_registers_free": ("gae", [REGISTERS_FREE]),
    "k5_no_chain": ("gae", [NO_CHAIN]),
    "k5_no_loads": ("gae", [NO_LOADS]),
    "k5_no_stores": ("gae", [NO_STORES]),
    "k5_empty": ("gae", [EMPTY]),
    **{f"k9_lanes_{v}": ("sample", [_set("SAMPLE_LANES", f"{v} ", "8 ")]) for v in (16, 32)},
    **{f"k9_warps_{v}": ("sample", [_set("SAMPLE_WARPS", v, 4)]) for v in (1, 2, 8)},
}
SYMBOL = {"gae": "bbx_gae", "sample": "bbx_sample"}
WRONG_BY_DESIGN = ("_no_chain", "_no_loads", "_no_stores", "_empty")


def read(csrc, kernel):
    with open(os.path.join(csrc, build.SOURCES[kernel])) as f:
        return f.read()


def replaced(text, pairs):
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"the source no longer holds {old!r}: update this script")
        text = text.replace(old, new)
    return text


def sources(parent):
    """{variant: (kernel, source text, include directory)}."""
    out = {}
    for kernel in ("gae", "sample"):
        out[f"{kernel}_this"] = (kernel, read(build.CSRC, kernel), build.CSRC)
        if parent:
            csrc = os.path.join(parent, "bbx_torch", "csrc")
            out[f"{kernel}_parent"] = (kernel, read(csrc, kernel), csrc)
    for name, (kernel, pairs) in VARIANTS.items():
        out[name] = (kernel, replaced(read(build.CSRC, kernel), pairs), build.CSRC)
    return out


def compile_all(srcs):
    work = os.path.join(ROOT, "build", "k5_k9_parts")
    os.makedirs(work, exist_ok=True)
    procs = {}
    for name, (_, text, include) in srcs.items():
        path = os.path.join(work, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", include,
               "-o", os.path.join(work, f"lib{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} does not compile:\n{log}")
        ptxas[name] = [line.strip() for line in log.splitlines()
                       if "registers" in line or "spill" in line]
        kernel = srcs[name][0]
        fn = getattr(ctypes.CDLL(os.path.join(work, f"lib{name}.so")), SYMBOL[kernel])
        fn.argtypes, fn.restype = build.SIGNATURES[kernel][2], ctypes.c_int
        fns[name] = fn
    return fns, ptxas


def device_ms(call, kernel_name, reps=30):
    """One call's device time of the kernel by `torch.profiler`, after a
    warm-up step of the profiler's schedule; a session that records none of
    its launches is taken again, twice at most, and then the time is "not
    measured"."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            call()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
            prof.step()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel_name in e.name]
        if times:
            return sum(times) / len(times)
    return "not measured"


def event_ms(call, reps=15, inner=20):
    """Median time a call between CUDA events over `inner` back-to-back
    calls."""
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[len(times) // 2]


def cases(dev):
    """{case: (kernel, args of the C entry point but the stream, the
    outputs, the plain version's outputs)}."""
    g = torch.Generator(device=dev).manual_seed(7)
    cfg = P.PPOConfig(gamma=0.99, gae_lambda=0.95)
    out = {}
    for t, n in GAE_SHAPES:
        r, v = torch.randn((t, n), generator=g, device=dev), torch.randn((t, n), generator=g,
                                                                          device=dev)
        d = torch.rand((t, n), generator=g, device=dev) < 0.02
        last = torch.randn(n, generator=g, device=dev)
        adv, ret = torch.empty_like(v), torch.empty_like(v)
        args = (r.data_ptr(), d.data_ptr(), v.data_ptr(), last.data_ptr(), adv.data_ptr(),
                ret.data_ptr(), cfg.gamma, cfg.gamma * cfg.gae_lambda, t, n)
        out[f"k5_{t}x{n}"] = ("gae", args, (adv, ret), P.compute_gae_plain(cfg, r, d, v, last),
                              (r, d, v, last))
    for n in SAMPLE_LANES:
        density = torch.rand((n, 1), generator=g, device=dev)
        mask = torch.rand((n, 192), generator=g, device=dev) < density
        seed = torch.randint(0, 2**32, (), generator=g, device=dev, dtype=torch.int64)
        actions = torch.empty(n, dtype=torch.int32, device=dev)
        args = (mask.data_ptr(), seed.data_ptr(), actions.data_ptr(), n)
        out[f"k9_{n}"] = ("sample", args, (actions,),
                          (V.sample_valid_actions_plain(mask, seed),), (mask, seed))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a checkout of another commit")
    ap.add_argument("--out", default=None, help="JSON results path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    srcs = sources(args.parent)
    fns, ptxas = compile_all(srcs)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for case, (kernel, cargs, outs, want, _) in cases(dev).items():
        names = [name for name in srcs if srcs[name][0] == kernel]
        for name in names + names[::-1]:
            def call(fn=fns[name], cargs=cargs, name=name):
                build.check(name, fn(*cargs, stream))

            for o in outs:
                o.fill_(0)
            call()
            torch.cuda.synchronize()
            row = {"case": case, "variant": name,
                   "equal": all(torch.equal(o, w) for o, w in zip(outs, want))
                   or name.endswith(WRONG_BY_DESIGN),
                   "ms": event_ms(call),
                   "device_ms": device_ms(call, f"{kernel}_kernel")}
            rows.append(row)
            print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi.strip(), "ptxas": ptxas, "rows": rows}, f, indent=2)
    bad = [(r["case"], r["variant"]) for r in rows if not r["equal"]]
    if bad:
        print(f"not equal to the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
