#!/usr/bin/env python3
"""Count what the rollout kernels issue: their SASS, by opcode and by pipe.

usage: python scripts/torch_sass_mix.py [--csrc DIR] [--label NAME]
                                        [--out FILE]

Builds the rollout library as ``q1physrl_torch.ops.env_rollout.build()``
does (or, with ``--csrc``, the same flags on another copy of ``csrc/``, such
as an earlier commit's), disassembles it with ``cuobjdump -sass`` and, for
each of the three rollout kernels, finds the main T loop (of the natural
loops with the most blocks, the one entered without running a frame;
``loop_at``, ``loop_copies``: see :func:`t_loop`) and prints one JSON line:

- ``loop``: the static instruction count of the loop body, by pipe class
  (``fp32``: FADD/FMUL/FFMA/FSEL/FSETP/...; ``int``: IMAD*/IADD3/LOP3/SHF/
  ISETP/...; ``conv``: I2F/F2I/FRND/...; ``mufu``; ``branch``; ``mem``;
  ``uniform``: the uniform datapath; ``other``) and by opcode;
- ``every_frame``: the same for the blocks that dominate the loop's latch,
  which run on every frame; ``conditional``: each other block of the loop,
  with its size, classes and, where the toolkit's ``nvdisasm`` reads a
  ``-lineinfo`` build of the same source, the source functions its
  instructions come from (``philox``, ``env_step``, ``reset_env``, ...);
- ``registers`` and stack bytes (``ptxas -v``), threads per block, blocks
  per SM (the library's own occupancy query where it has one, else from the
  registers) and the waves of a launch at the bench shape (N = 2^20,
  ``chip_smoke.BENCH_ENV``) on this card's SMs.

``cuobjdump`` and ``nvdisasm`` come from the CUDA toolkit (``$CUDA_HOME``
or ``PATH``), else from Triton's package.  Needs ``nvcc``; the card is only
asked for its SM count and the occupancy query.  On a machine with one H100:

    python scripts/torch_sass_mix.py
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import BENCH_ENV  # noqa: E402
from q1physrl_torch.ops import env_rollout  # noqa: E402

# Each kernel of the library and its wrapper, whose id the library's
# q1_launch_shape takes (env_rollout._KERNEL_IDS).
KERNELS = {"rollout_actions_kernel": "rollout_actions",
           "rollout_autoreset_kernel": "rollout_actions_autoreset",
           "rollout_random_kernel": "rollout_random"}

CLASSES = {
    "fp32": {"FADD", "FMUL", "FFMA", "FSEL", "FSETP", "FMNMX", "FCHK",
             "FSET", "FADD32I", "FMUL32I", "FFMA32I", "FSWZADD"},
    "int": {"IMAD", "IADD3", "LOP3", "SHF", "ISETP", "IMNMX", "IABS", "LEA",
            "SEL", "PRMT", "IADD", "IMUL", "ISCADD", "POPC", "FLO", "BREV",
            "SGXT", "BMSK", "LOP", "LOP32I", "IADD32I", "PLOP3", "P2R", "R2P",
            "VIADD", "VIMNMX", "IDP", "VABSDIFF", "ICMP", "SHL", "SHR"},
    "conv": {"I2F", "F2I", "FRND", "F2F", "I2I", "I2FP", "F2IP"},
    "mufu": {"MUFU"},
    "branch": {"BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY",
               "BSYNC", "BREAK", "BMOV", "WARPSYNC", "YIELD", "KILL", "BPT",
               "NANOSLEEP"},
    "mem": {"LDG", "STG", "LDL", "STL", "LDS", "STS", "LDC", "LD", "ST",
            "ATOM", "ATOMG", "RED", "ULDC", "LDSM", "ATOMS"},
}
_CLASS_OF = {op: c for c, ops in CLASSES.items() for op in ops}

_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_[\w]+):")
_FUNC = re.compile(r"Function : (\S+)|^\s*\.section\s+\.text\.([^,\s]+)")
_LINE = re.compile(r'//## File "([^"]+)", line (\d+)')
_AT = re.compile(r'inlined at "([^"]+)", line (\d+)')
_GUARD = re.compile(r"^@!?U?P[T0-9]+\s+")
_TARGET = re.compile(r"`\((\.L_[\w]+)\)|\b(0x[0-9a-f]+)\b")


def op_class(base: str) -> str:
    if base in _CLASS_OF:
        return _CLASS_OF[base]
    return "uniform" if base.startswith("U") or base == "R2UR" else "other"


class Instr:
    __slots__ = ("addr", "guard", "op", "base", "args", "target", "where")

    def __init__(self, addr, text, where):
        self.addr = addr
        m = _GUARD.match(text)
        self.guard = m.group(0).strip() if m else ""
        text = text[m.end():] if m else text
        self.op, _, self.args = text.partition(" ")
        self.base = self.op.split(".")[0]
        self.target = None
        self.where = where  # [(file, line), ...], innermost first

    @property
    def conditional(self):
        return ((self.guard and self.guard != "@PT")
                or re.search(r"\bU?P[0-6]\b", self.args) is not None)


def _tool(name):
    path = shutil.which(name)
    if path:
        return path
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if cuda.exists():
        return str(cuda)
    spec = importlib.util.find_spec("triton")
    if spec and spec.submodule_search_locations:
        p = (Path(spec.submodule_search_locations[0]) / "backends" / "nvidia"
             / "bin" / name)
        if p.exists():
            return str(p)
    return None


def parse_sass(text):
    """{function: [Instr]} from cuobjdump or nvdisasm output; branch targets
    resolved to addresses, line info (nvdisasm -g/-gi) attached."""
    funcs, labels = {}, {}
    cur, where, pending, fresh = None, [], [], True
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = m.group(1) or m.group(2)
            funcs[cur], labels[cur], pending = [], {}, []
            continue
        if cur is None:
            continue
        m = _LINE.search(line)
        if m:
            # nvdisasm -gi prints an inlined site's full chain, then a line
            # for each caller: the longest chain names the instruction.
            chain = [(m.group(1), int(m.group(2)))] + [
                (f, int(n)) for f, n in _AT.findall(line)]
            if fresh or len(chain) > len(where):
                where = chain
            fresh = False
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.match(line)
        if m:
            ins = Instr(int(m.group(1), 16), m.group(2), where)
            fresh = True
            for lab in pending:
                labels[cur][lab] = ins.addr
            pending = []
            funcs[cur].append(ins)
    for name, code in funcs.items():
        for ins in code:
            if ins.base in ("BRA", "JMP", "CALL", "BRX"):
                t = _TARGET.search(ins.args)
                if t:
                    ins.target = (labels[name].get(t.group(1)) if t.group(1)
                                  else int(t.group(2), 16))
    return funcs


def blocks_of(code):
    """Basic blocks as (start, end) index ranges and their successors."""
    index = {ins.addr: i for i, ins in enumerate(code)}
    leaders = {0}
    for i, ins in enumerate(code):
        if ins.base in ("BRA", "JMP", "BRX", "EXIT", "RET"):
            leaders.add(i + 1)
            if ins.target in index and ins.base != "CALL":
                leaders.add(index[ins.target])
    starts = sorted(s for s in leaders if s < len(code))
    ranges = list(zip(starts, starts[1:] + [len(code)]))
    block_at = {s: b for b, (s, _) in enumerate(ranges)}
    succ = []
    for b, (s, e) in enumerate(ranges):
        last = code[e - 1]
        nxt = [b + 1] if b + 1 < len(ranges) else []
        if last.base in ("BRA", "JMP") and last.target in index:
            tgt = [block_at[index[last.target]]]
            succ.append(tgt + nxt if last.conditional else tgt)
        elif last.base in ("EXIT", "RET", "BRX"):
            succ.append(nxt if last.conditional else [])
        else:
            succ.append(nxt)
    return ranges, succ


def natural_loops(succ):
    """[(header, body blocks, latches)] of the natural loops."""
    pred = collections.defaultdict(list)
    for b, ss in enumerate(succ):
        for s in ss:
            pred[s].append(b)
    loops = []
    for h in range(len(succ)):
        latches = [u for u in pred[h] if u >= h]
        if not latches:
            continue
        body, stack = {h}, list(latches)
        while stack:
            u = stack.pop()
            if u not in body:
                body.add(u)
                stack.extend(pred[u])
        loops.append((h, body, latches))
    return loops


def t_loop(code, ranges, succ):
    """(header, body blocks, latches) of the main T loop, and the number of
    copies of it.  rollout_random holds two: the main one, and the one an
    env with a hand-made key latch enters after its first frame
    (csrc/env_rollout.cu, latches_are_bits).  Both have the most blocks;
    the main one is entered without running a frame, so no MUFU (the
    step's square roots and divides) lies on every path into it.
    rollout_actions and rollout_actions_autoreset hold one, entered after
    frame 0 (run_frames)."""
    loops = natural_loops(succ)
    if not loops:
        return None, 0
    most = max(len(body) for _, body, _ in loops)
    copies = [loop for loop in loops if len(loop[1]) == most]
    dom = dominators(0, set(range(len(succ))), succ)

    def after_a_frame(loop):
        return any(code[i].base == "MUFU" for b in dom[loop[0]] - loop[1]
                   for i in range(*ranges[b]))

    return min(copies, key=after_a_frame), len(copies)


def dominators(header, body, succ):
    """Dominator sets of the loop's blocks, in the loop's own graph."""
    pred = {b: [p for p in body if b in succ[p] and not (b == header)]
            for b in body}
    dom = {b: set(body) for b in body}
    dom[header] = {header}
    changed = True
    while changed:
        changed = False
        for b in sorted(body):
            if b == header or not pred[b]:
                continue
            new = set.intersection(*(dom[p] for p in pred[b])) | {b}
            if new != dom[b]:
                dom[b], changed = new, True
    return dom


def source_functions(csrc):
    """[(file, first line, last line, name)] of the device functions and
    kernels in the sources, for naming where an instruction came from."""
    spans = []
    for path in sorted(Path(csrc).glob("*.cu*")):
        text = path.read_text()
        lines = text.splitlines()
        for m in re.finditer(r"^(?:__device__|__global__)\b(.*?)\{", text,
                             re.S | re.M):
            name = next(n for n in re.findall(r"(\w+)\s*\(", m.group(1))
                        if n != "__launch_bounds__")
            start = text.count("\n", 0, m.start()) + 1
            end = next((i for i in range(start, len(lines) + 1)
                        if lines[i - 1].startswith("}")), len(lines))
            spans.append((path.name, start, end, name))
    return spans


def role(where, spans):
    """The source function an instruction came from, innermost; a function
    of philox.cuh is named with the first caller outside it, where the line
    info holds the inlining chain ('philox4x32_10@rollout_random_kernel')."""
    if not where:
        return "?"
    names = []
    for f, line in where:
        base = Path(f).name
        hit = [n for fn, a, b, n in spans if fn == base and a <= line <= b]
        names.append((base, hit[-1] if hit else f"{base}:{line}"))
    if names[0][0] == "philox.cuh":
        outer = [n for f, n in names[1:] if f != "philox.cuh"]
        return f"{names[0][1]}@{outer[0]}" if outer else names[0][1]
    return names[0][1]


def counts(instrs):
    by_class = collections.Counter(op_class(i.base) for i in instrs)
    return {"instructions": len(instrs), "classes": dict(by_class.most_common())}


def analyse(code, spans):
    ranges, succ = blocks_of(code)
    found, copies = t_loop(code, ranges, succ)
    if found is None:
        return None
    header, body, latches = found
    dom = dominators(header, body, succ)
    always = set.intersection(*(dom[u] for u in latches))
    loop = [i for b in sorted(body) for i in code[slice(*ranges[b])]]
    every = [i for b in sorted(always) for i in code[slice(*ranges[b])]]
    out = {"loop_at": hex(code[ranges[header][0]].addr),
           "loop_copies": copies,
           "loop": {**counts(loop), "opcodes": dict(collections.Counter(
               i.op for i in loop).most_common())},
           "every_frame": {**counts(every), "opcodes": dict(
               collections.Counter(i.op for i in every).most_common())},
           "loop_roles": dict(collections.Counter(
               role(i.where, spans) for i in loop).most_common()),
           "every_frame_roles": dict(collections.Counter(
               role(i.where, spans) for i in every).most_common()),
           "conditional": []}
    for b in sorted(body - always):
        ins = code[slice(*ranges[b])]
        lines = sorted({i.where[0][1] for i in ins if i.where})
        out["conditional"].append({
            "at": hex(ins[0].addr), **counts(ins),
            "lines": f"{lines[0]}-{lines[-1]}" if lines else None,
            "roles": dict(collections.Counter(
                role(i.where, spans) for i in ins).most_common())})
    calls = [i for i in loop if i.base == "CALL"]
    out["calls"] = len(calls)
    return out


def _kernel_name(mangled):
    """The kernel a mangled name belongs to; of a template on the number of
    keys, only its K=4 instance (run4's) counts."""
    k = re.search(r"ILi(\d+)E", mangled)
    if k and k.group(1) != "4":
        return None
    return next((k for k in KERNELS if k in mangled), None)


def _ptxas(log):
    """{kernel: (registers, stack bytes)} from a ``-Xptxas=-v`` report."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = _kernel_name(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            stack = re.search(r"(\d+) bytes cumulative stack", line)
            out[cur] = (int(m.group(1)), int(stack.group(1)) if stack else 0)
            cur = None
    return out


def _device_flags():
    drop = {"-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"}
    return [f for f in env_rollout._NVCC_FLAGS if f not in drop]


def build(csrc, workdir):
    """(library path, ptxas log) built with env_rollout's flags."""
    if Path(csrc).resolve() == env_rollout._CSRC.resolve():
        lib = env_rollout.build()
    else:
        lib = env_rollout.compile_library(Path(csrc) / "env_rollout.cu",
                                          Path(workdir) / "env_rollout.so")
    return lib, lib.with_suffix(".log").read_text()


def line_info(csrc, workdir, nvdisasm):
    """({kernel: [Instr] with line info}, nvdisasm's text) from a -lineinfo
    cubin of the same source; ({}, "") when nvdisasm is missing or fails."""
    if nvdisasm is None:
        return {}, ""
    cubin = Path(workdir) / "lineinfo.cubin"
    subprocess.run([env_rollout._nvcc(), "-cubin", *_device_flags(),
                    "-lineinfo", "-I", str(csrc), "-o", str(cubin),
                    str(Path(csrc) / "env_rollout.cu")], check=True,
                   capture_output=True)
    for flag in ("-gi", "-g"):
        proc = subprocess.run([nvdisasm, "-c", flag, str(cubin)],
                              capture_output=True, text=True)
        if proc.returncode == 0:
            break
    else:
        return {}, ""
    out = {}
    for name, code in parse_sass(proc.stdout).items():
        k = _kernel_name(name)
        if k:
            out[k] = code
    return out, proc.stdout


def launch_shape(lib, kernel, n, regs, threads_default):
    """(threads per block, blocks, blocks per SM, how the last was found)."""
    try:
        dll = ctypes.CDLL(str(lib))
        fn = dll.q1_launch_shape
    except (OSError, AttributeError):
        fn = None
    if fn is not None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 3)()
        if fn(env_rollout._KERNEL_IDS[KERNELS[kernel]], n, 4, out) == 0:
            return out[0], out[1], out[2], "cudaOccupancy"
    threads = threads_default
    per_warp = -(-regs * 32 // 256) * 256
    warps = threads // 32
    by_regs = (65536 // per_warp) // warps
    return (threads, -(-n // threads), min(by_regs, 2048 // threads, 32),
            "registers")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--csrc", default=str(env_rollout._CSRC),
                        help="directory holding env_rollout.cu and philox.cuh")
    parser.add_argument("--label", default="this tree")
    parser.add_argument("--out", help="also write the full JSON lines here")
    args = parser.parse_args(argv)
    cuobjdump = _tool("cuobjdump")
    if cuobjdump is None:
        raise SystemExit("cuobjdump not found (CUDA toolkit or triton)")
    import torch

    sms = (torch.cuda.get_device_properties(0).multi_processor_count
           if torch.cuda.is_available() else None)
    src = (Path(args.csrc) / "env_rollout.cu").read_text()
    m = re.search(r"constexpr int kThreads = (\d+);", src)
    threads_default = int(m.group(1)) if m else 256
    spans = source_functions(args.csrc)
    lines = []
    with tempfile.TemporaryDirectory(prefix="q1_sass_") as work:
        lib, log = build(args.csrc, work)
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        funcs = {_kernel_name(k): v for k, v in parse_sass(sass).items()
                 if _kernel_name(k)}
        info, lined_sass = line_info(args.csrc, work, _tool("nvdisasm"))
        regs = _ptxas(log)
        for kernel in KERNELS:
            code = funcs[kernel]
            lined = info.get(kernel)
            same = (lined is not None and [i.op for i in lined]
                    == [i.op for i in code])
            if same:  # the -lineinfo build issues the same instructions
                for a, b in zip(code, lined):
                    a.where = b.where
            r, stack = regs.get(kernel, (None, None))
            threads, blocks, per_sm, how = launch_shape(
                lib, kernel, BENCH_ENV["n"], r or 255, threads_default)
            resident = per_sm * sms if sms else None
            line = {"sass_mix": kernel, "label": args.label,
                    "registers": r, "stack_bytes": stack,
                    "threads_per_block": threads, "blocks_per_sm": per_sm,
                    "blocks_per_sm_from": how, "sms": sms, "n": BENCH_ENV["n"],
                    "blocks": blocks,
                    "waves": blocks / resident if resident else None,
                    "line_info": bool(same),
                    "function_instructions": len(code),
                    **analyse(code, spans)}
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
        Path(args.out).with_suffix(".sass").write_text(sass)
        Path(args.out).with_suffix(".lineinfo.sass").write_text(lined_sass)
    return 0


if __name__ == "__main__":
    sys.exit(main())
