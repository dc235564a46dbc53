"""K1 (the valid-anchor masks) and K2 (the disjoint solvability tier)
against another commit's, with K7 beside them, timed on the card in turns.

    python3 scripts_dev/torch_k1_k2_parts.py [--parent DIR] [--out FILE]

Compiles this tree's `bbx_torch/csrc/valid3.cu`, `solvable_disjoint.cu`
and `regen.cu`, variants of the first two edited by exact strings, and
with `--parent DIR` (a checkout of another commit, e.g. unpacked from `git
archive`) that commit's three sources with its own headers (its
`verdict.cuh` among them), into `build/k1_k2_parts/`, each with its ptxas
registers and spills.  The inputs are `chip_smoke.py`'s: K1 on its
mid-game boards at 1 and 512 lanes and on the engine step's boards at
16,384; K2 on the mid-game boards and their masks at 1 and 4,096 lanes; K7
on the engine step's inputs (16,384 lanes).  Each variant runs each of its
kernel's cases in turns (the list, then the list reversed): its output
against the plain version (bit for bit), its time between CUDA events
over back-to-back calls (`ms`) and its kernel's device time by
`torch.profiler` (`device_ms`).  The variants:
  k1_threads_64, k1_threads_256  K1 with 64 or 256 threads a block (128);
  k1_tables_global    K1 reading the shifts and anchor masks from global
                      memory at the piece's id, with no staging and no
                      block barrier;
  k1_chunks_2, k1_chunks_4  K1 with 2 or 4 chunks of 16 bytes a thread (1);
  k1_empty            K1 returning at once (a launch of the same grid);
  k2_warps_4, k2_warps_8, k2_warps_32  K2 with 4, 8 or 32 lanes (warps) a
                      block (16);
  k2_empty            K2 returning at once.
The `_empty` variants' results are wrong by design.  The script stops when
an edit's string is gone from the source.  Needs a CUDA card.
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

import chip_smoke as CS  # noqa: E402
from bbx_torch.engine import solvability as S  # noqa: E402
from bbx_torch.engine import state as ES  # noqa: E402
from bbx_torch.engine.tables import tables  # noqa: E402
from bbx_torch.ops import build  # noqa: E402


def _set(name, value, default):
    return (f"#define {name} {default}", f"#define {name} {value}")


TABLES_GLOBAL = [
    ("""#pragma unroll
    for (int j = 0; j < (VALID3_TABLE_SHIFTS + VALID3_THREADS - 1) / VALID3_THREADS; ++j) {
        const int i = t + j * VALID3_THREADS;
        if (i < VALID3_TABLE_SHIFTS) s_shift[i] = shifts[i];
    }
    if (t < BB_NUM_PIECES) s_aok[t] = (u64)anchor_ok[t];
    __syncthreads();
""", ""),
    ("bb_fit(b, s_shift + BB_SHIFTS * p, s_aok[p])",
     "bb_fit(b, shifts + BB_SHIFTS * p, (u64)__ldg(anchor_ok + p))"),
]


def chunks(v):
    """K1 with v 16-byte chunks a thread: a block writes v runs of
    VALID3_THREADS neighbouring chunks, a chunk of each run a thread, all
    of a thread's loads issued before the block barrier."""
    return [
        ("#define VALID3_THREADS 128\n",
         f"#define VALID3_THREADS 128\n#define VALID3_CHUNKS {v}\n"),
        ("""    const int c = blockIdx.x * VALID3_THREADS + t;
    const u64 b = c < n ? bb_load(bits + 2 * (c / 12)) : 0;
    const int p = c < n ? ids[c / 4] : -1;
""", """    const int first = blockIdx.x * VALID3_CHUNKS * VALID3_THREADS + t;
    u64 bs[VALID3_CHUNKS];
    int ps[VALID3_CHUNKS];
#pragma unroll
    for (int j = 0; j < VALID3_CHUNKS; ++j) {
        const int c = first + j * VALID3_THREADS;
        bs[j] = c < n ? bb_load(bits + 2 * (c / 12)) : 0;
        ps[j] = c < n ? ids[c / 4] : -1;
    }
"""),
        ("""    __syncthreads();
    if (c >= n) return;
""", """    __syncthreads();
#pragma unroll
    for (int j = 0; j < VALID3_CHUNKS; ++j) {
    const int c = first + j * VALID3_THREADS;
    const u64 b = bs[j];
    const int p = ps[j];
    if (c >= n) return;
"""),
        ("""                        valid3_spread4(h >> 12));
}
""", """                        valid3_spread4(h >> 12));
    }
}
"""),
        ("(n + VALID3_THREADS - 1) / VALID3_THREADS,",
         "(n + VALID3_CHUNKS * VALID3_THREADS - 1) / (VALID3_CHUNKS * VALID3_THREADS),"),
    ]


K1_EMPTY = ("    const int t = threadIdx.x;\n",
            "    if (n > 0) return;\n    const int t = threadIdx.x;\n")
K2_EMPTY = ("    if (lane >= k) return;  // a whole warp\n", "    if (k > 0) return;\n")

# Each variant: its kernel and its edits of this tree's source.
VARIANTS = {
    **{f"k1_threads_{v}": ("valid3", [_set("VALID3_THREADS", v, 128)]) for v in (64, 256)},
    "k1_tables_global": ("valid3", TABLES_GLOBAL),
    "k1_empty": ("valid3", [K1_EMPTY]),
    **{f"k1_chunks_{v}": ("valid3", chunks(v)) for v in (2, 4)},
    **{f"k2_warps_{v}": ("solvable_disjoint", [_set("DISJOINT_WARPS", f"{v} ", "16 ")])
       for v in (4, 8, 32)},
    "k2_empty": ("solvable_disjoint", [K2_EMPTY]),
}
KERNELS = ("valid3", "solvable_disjoint", "regen")
DEVICE_NAME = {"valid3": "valid3_kernel", "solvable_disjoint": "disjoint_kernel",
               "regen": "regen_kernel"}
WRONG_BY_DESIGN = ("_empty",)


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
    for kernel in KERNELS:
        out[f"{kernel}_this"] = (kernel, read(build.CSRC, kernel), build.CSRC)
        if parent:
            csrc = os.path.join(parent, "bbx_torch", "csrc")
            out[f"{kernel}_parent"] = (kernel, read(csrc, kernel), csrc)
    for name, (kernel, pairs) in VARIANTS.items():
        out[name] = (kernel, replaced(read(build.CSRC, kernel), pairs), build.CSRC)
    return out


def compile_all(srcs):
    work = os.path.join(ROOT, "build", "k1_k2_parts")
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
        _, symbol, argtypes = build.SIGNATURES[srcs[name][0]]
        fn = getattr(ctypes.CDLL(os.path.join(work, f"lib{name}.so")), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns, ptxas


def cases(dev):
    """{case: (kernel, args of the C entry point but the stream, the
    outputs, the plain version's outputs, the tensors the args point
    into)}."""
    tb = tables(dev)
    _, _, bits, ids = CS.midgame_boards(dev)
    eng = CS.engine_step_inputs(dev)
    eng_ids = ES.regen_pieces(eng["bits"], eng["ids"], eng["seed"], eng["need"])[0]
    out = {}
    for k, b, i in ((1, bits[:1], ids[:1]), (CS.K1_LANES, bits[:CS.K1_LANES], ids[:CS.K1_LANES]),
                    (CS.ENGINE_LANES, eng["bits"], eng_ids)):
        b, i = b.contiguous(), i.contiguous()
        o = torch.empty((k, 3, 64), dtype=torch.bool, device=dev)
        args = (b.data_ptr(), i.data_ptr(), tb.PIECE_SHIFTS_I32.data_ptr(),
                tb.ANCHOR_OK_U64.data_ptr(), o.data_ptr(), k)
        out[f"k1_{k}"] = ("valid3", args, (o,), (S.valid3_bits_plain(b, i),), (b, i))
    v3 = S.valid3_bits_plain(bits, ids)
    for k in (1, CS.FLEET):
        i, v = ids[:k].contiguous(), v3[:k].contiguous()
        o = torch.empty(k, dtype=torch.bool, device=dev)
        args = (i.data_ptr(), v.data_ptr(), tb.NO_CONFLICT_U64.data_ptr(), o.data_ptr(), k)
        out[f"k2_{k}"] = ("solvable_disjoint", args, (o,),
                          (S.solvable_disjoint_bits_plain(bits[:k], i, v),), (i, v))
    n = CS.ENGINE_LANES
    seed = eng["seed"].reshape(())
    got_ids = torch.empty((n, 3), dtype=torch.int32, device=dev)
    attempts = torch.empty(n, dtype=torch.int32, device=dev)
    args = (eng["bits"].data_ptr(), eng["ids"].data_ptr(), eng["need"].data_ptr(),
            seed.data_ptr(), tb.PLACE_U64.data_ptr(), tb.PIECE_SHIFTS_I32.data_ptr(),
            tb.ANCHOR_OK_U64.data_ptr(), tb.NO_CONFLICT_U64.data_ptr(), got_ids.data_ptr(),
            attempts.data_ptr(), n)
    out[f"k7_{n}"] = ("regen", args, (got_ids, attempts),
                      ES.regen_pieces_plain(eng["bits"], eng["ids"], seed, eng["need"]),
                      (eng, seed))
    return out


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
                   "device_ms": device_ms(call, DEVICE_NAME[kernel])}
            rows.append(row)
            print(json.dumps(row), flush=True)
    smi = CS.nvidia_smi()
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "ptxas": ptxas, "rows": rows}, f, indent=2)
    bad = [(r["case"], r["variant"]) for r in rows if not r["equal"]]
    if bad:
        print(f"not equal to the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
