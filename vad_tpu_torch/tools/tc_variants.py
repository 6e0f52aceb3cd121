"""Variants of the bf16 stepwise_tc step, timed on the card: what holds it.

Builds ``csrc/convlstm_serving.cu`` as it is and in variants, each a text
patch of a copy of the sources (one ``nvcc`` each, all at once), and times
kernel 1 at S=16 and B=1 and kernel 2 at B=8 on a 32x32 latent (512x512
streams, C=128, T=16, bf16) in the stepwise_tc design through each build's
C entry point:

- ``built``: the sources as they are;
- ``two_blocks``: two blocks an SM for the bf16 step, not three;
- ``ieee_activations``: the bf16 epilogue on expf / tanhf, not the
  hardware tanh;
- ablations, whose outputs are wrong by construction: ``no_mma`` (no
  wgmma, and so no A fragments), ``no_epilogue_math`` (the gate math and
  gates_x reads left out), ``no_halo_copy`` (every halo row zero-filled),
  ``no_b_copy`` (the mbarrier completes without B's bulk copy).

It prints one JSON line per (variant, call) with ms (CUDA events), the
max |error| against the plain version (of the built sources; the ablations'
say nothing), registers and spills, the card's name and its power limit.

``--backward`` does the same for kernel 3's bf16 stepwise_tc form
(``csrc/convlstm_backward.cu``) at the 512x512 train step's shape (B=8,
T=16, 32x32, C=128), each call also timed by part (gate recompute,
reverse loop, dWh, dh0 + the split sum) from a device profile:

- ``built``; ``dw_two_blocks`` (dWh's ring of 2 stages, two blocks an SM);
  ``dw_four_stages`` (a ring of 4);
- ablations: ``no_mma`` (the tile's wgmma gone: gate, loop, dh0),
  ``dw_no_mma`` (dWh's wgmma gone), ``dw_no_copy`` (dWh stages nothing),
  ``loop_no_epilogue_math`` (the loop's gate gradients and their reads
  left out).

Usage (on the card):
    python -m vad_tpu_torch.tools.tc_variants [--backward]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import torch

from vad_tpu_torch import bench
from vad_tpu_torch.ops import _build, convlstm
from vad_tpu_torch.utils.profiling import time_ms

CALLS = (("convlstm_serving", (16, 16, 32, 32, 128)), ("convlstm_serving", (1, 16, 32, 32, 128)),
         ("convlstm_train_forward", (8, 16, 32, 32, 128)))
SERVING, TILES, BACKWARD = "convlstm_serving.cu", "convlstm_tiles.cuh", "convlstm_backward.cu"
BWD_SHAPE = (8, 16, 32, 32, 128)
# kernel 3's stepwise_tc launches by device-side name: its parts
BWD_PARTS = {"gate_tc": "gate", "dh_tc_step": "loop", "dw_tc": "dw", "finish_tc": "dh0+dw_sum"}
_EPI_START = "    const float gi = tc_rank_sum(x + 0 * 16, ranks) + to_f32(gx[0 * s.C]);"
_EPI_END = "    c_state[sidx] = c_new;\n    h_seq[(bt * hw + p) * s.C + ch] = from_f32<T>(h_new);"


def _replace(old: str, new: str, name: str = SERVING) -> Callable[[Dict[str, str]], None]:
    def patch(src: Dict[str, str]) -> None:
        if old not in src[name]:
            raise RuntimeError(f"tc_variants: the patch's text is not in {name}: {old[:60]!r}")
        src[name] = src[name].replace(old, new)
    return patch


def _no_epilogue_math(src: Dict[str, str]) -> None:
    text = src[SERVING]
    start = text.index(_EPI_START)  # the stepwise_tc step's epilogue
    end = text.index(_EPI_END, start)
    src[SERVING] = (text[:start] + "    const size_t sidx = (size_t)r * s.C + ch;\n"
                    "    const float c_new = x[0], h_new = x[0];\n" + text[end:])


VARIANTS: Dict[str, Callable[[Dict[str, str]], None]] = {
    "built": lambda src: None,
    "two_blocks": _replace("sizeof(T) == 2 ? 3 : 2)", "2)"),
    "ieee_activations": _replace(
        "c_new = sigmoid_fast(gf) * c_state[sidx] + sigmoid_fast(gi) * tanh_fast(gg);\n"
        "      h_new = sigmoid_fast(go) * tanh_fast(c_new);",
        "c_new = sigmoid(gf) * c_state[sidx] + sigmoid(gi) * tanhf(gg);\n"
        "      h_new = sigmoid(go) * tanhf(c_new);"),
    "no_mma": _replace("          mma_bf16_ra(acc, a[tap], desc(B + tap * TC_BTAP_BF16, 1024, 128));",
                       "          ;", TILES),
    "no_epilogue_math": _no_epilogue_math,
    "no_halo_copy": _replace("          if (ch >= s.C) return nullptr;", "          return nullptr;"),
    "no_b_copy": _replace(
        "    mbar_expect_tx(bar, tc_bbytes<T>());\n"
        "    bulk_copy(st + tc_a_bytes(NW, W), b_src, tc_bbytes<T>(), bar);",
        '    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(smem_u32(bar))'
        ' : "memory");', TILES),
}


_DH_GRAD = ("    const GateGrad gg = gate_grad(a[0], a[s.C], a[2 * s.C], a[3 * s.C], tanh_ct, cp,\n"
            "                                  to_f32(dh_seq[cidx]) + dh, dc_carry[sidx]);")

BWD_VARIANTS: Dict[str, Callable[[Dict[str, str]], None]] = {
    "built": lambda src: None,
    "dw_two_blocks": lambda src: [patch(src) for patch in (
        _replace("constexpr int DW_NSTAGE = 3;", "constexpr int DW_NSTAGE = 2;", BACKWARD),
        _replace("__launch_bounds__(DW_THREADS, 1)", "__launch_bounds__(DW_THREADS, 2)",
                 BACKWARD))],
    "dw_four_stages": _replace("constexpr int DW_NSTAGE = 3;", "constexpr int DW_NSTAGE = 4;",
                               BACKWARD),
    "no_mma": VARIANTS["no_mma"],
    "dw_no_mma": _replace(
        "        for (int mt = 0; mt < MT; ++mt) "
        "mma<1, 1>(acc[mt], desc(a + mt * 8 * PH, 128, PH), db);",
        "        (void)a, (void)db;", BACKWARD),
    "dw_no_copy": _replace("  const auto load = [&](int u, unsigned char* st) {\n",
                           "  const auto load = [&](int u, unsigned char* st) {\n"
                           "    if (u >= 0) return;\n", BACKWARD),
    "loop_no_epilogue_math": _replace(_DH_GRAD, "    const GateGrad gg = {dh, dh, dh, dh, dh};",
                                      BACKWARD),
}


def build(workdir: Path, variants=None, source: str = SERVING,
          signatures: Optional[dict] = None) -> Dict[str, tuple]:
    """Every variant's library of ``source`` (kernels 1-2's, or kernel 3's)
    and its ptxas log: ``{name: (CDLL, log)}``."""
    csrc = _build.CSRC_DIR
    variants = VARIANTS if variants is None else variants
    signatures = convlstm._SIGNATURES if signatures is None else signatures
    jobs = {}
    for name, patch in variants.items():
        src = {f.name: f.read_text() for f in (*csrc.glob("*.cuh"), csrc / source)}
        patch(src)
        out = workdir / name
        out.mkdir()
        for fname, text in src.items():
            (out / fname).write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "lib.so"), str(out / source)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(workdir / name / "lib.so"))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        err = getattr(lib, f"{Path(source).stem}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        libs[name] = (lib, log)
    return libs


def call(lib, gx, wh, h0, c0, cell: bool, plan) -> torch.Tensor:
    """One call of kernel 1 (or 2 with ``cell``) through ``lib``, as
    ``ops/convlstm._forward_kernel`` makes it; returns h_seq."""
    b, t, hgt, wid, four_c = gx.shape
    w_t = convlstm._tc_weights(wh, "fwd")
    h0_in, c = h0.to(gx.dtype).contiguous(), c0.clone()
    h_final = torch.empty(h0.shape, device=gx.device)
    h_seq = torch.empty((b, t, hgt, wid, four_c // 4), dtype=gx.dtype, device=gx.device)
    c_seq = torch.empty_like(h_seq) if cell else None
    shape = (b, t, hgt, wid, four_c // 4, 1, 2, plan.cluster, plan.warpgroups,
             torch.cuda.current_stream().cuda_stream)
    ptrs = [gx.data_ptr(), wh.data_ptr(), w_t.data_ptr(), h0_in.data_ptr(), c.data_ptr(),
            h_seq.data_ptr()] + ([c_seq.data_ptr()] if cell else []) + [h_final.data_ptr()]
    fn = lib.convlstm_train_forward if cell else lib.convlstm_serving_forward
    status = fn(*ptrs, *shape)
    if status != 0:
        raise RuntimeError(f"tc_variants: launch failed with CUDA error {status}")
    return h_seq


def kernel_registers(log: str, keep: Callable[[str], bool]) -> Dict[str, list]:
    """Registers and spill-store bytes of each kernel whose mangled name
    ``keep`` takes, in a ``-Xptxas -v`` log: ``{name: [registers, spills]}``."""
    out, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            name = found.group(1) if keep(found.group(1)) else None
        elif name is not None:
            spill = re.search(r"(\d+) bytes spill stores", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                out.setdefault(name, [None, None])[1] = int(spill.group(1))
            if regs:
                out.setdefault(name, [None, None])[0] = int(regs.group(1))
    return out


def bf16_step_registers(log: str) -> Dict[str, list]:
    """The bf16 stepwise_tc step kernels' registers and spills."""
    return kernel_registers(log, lambda n: "convlstm_tc_step" in n and "13__nv_bfloat16" in n)


def bwd_registers(log: str) -> Dict[str, list]:
    """Kernel 3's bf16 stepwise_tc kernels' registers and spills."""
    return kernel_registers(log, lambda n: any(k in n for k in BWD_PARTS)
                            and ("13__nv_bfloat16" in n or "dw_tc" in n))


@contextmanager
def through(lib):
    """``ops/convlstm``'s kernel 3 wrapper launching through ``lib``."""
    name = convlstm._BWD_KERNEL
    real = _build._libraries.get(name)
    _build._libraries[name] = lib
    try:
        yield
    finally:
        if real is None:
            _build._libraries.pop(name, None)
        else:
            _build._libraries[name] = real


def bwd_part_ms(run) -> Dict[str, float]:
    """Device ms of one call of ``run`` by kernel 3's parts (torch.profiler
    over two calls, device-side events only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
    parts: Dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for kname, part in BWD_PARTS.items():
            if kname in e.key:
                parts[part] = parts.get(part, 0.0) + e.self_device_time_total / 2 / 1e3
    return parts


def main_backward(card: str, limit) -> None:
    """Kernel 3's bf16 stepwise_tc variants at ``BWD_SHAPE``, by part."""
    b, t, hgt, wid, ch = BWD_SHAPE
    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *dims, scale=1.0: torch.randn(dims, generator=g, device="cuda") * scale  # noqa
    gx = rnd(b, t, hgt, wid, 4 * ch, scale=0.5).to(dt)
    wh = rnd(3, 3, ch, 4 * ch, scale=0.05).to(dt)
    h0, c0 = rnd(b, hgt, wid, ch, scale=0.1), rnd(b, hgt, wid, ch, scale=0.1)
    hs, cs, _ = convlstm.convlstm_forward_ref(gx, wh, h0, c0, with_cell_seq=True)
    args = (gx, wh, h0, c0, hs, cs, rnd(b, t, hgt, wid, ch).to(dt), rnd(b, hgt, wid, ch),
            rnd(b, hgt, wid, ch))
    ref = convlstm.convlstm_backward_ref(*args)
    plan = convlstm.recurrence_plan("convlstm_backward", *BWD_SHAPE, dt, "stepwise_tc")
    with tempfile.TemporaryDirectory(prefix="tc_variants_") as tmp:
        libs = build(Path(tmp), BWD_VARIANTS, BACKWARD, convlstm._BWD_SIGNATURES)
        for name, (lib, log) in libs.items():
            with through(lib):
                def run():
                    return convlstm._backward_kernel(*args, plan=plan)

                got = run()
                err = {n: float((a.float() - r.float()).abs().max()) for n, a, r in zip(
                    ("dgates_x", "dw_h", "dh0", "dc0"), got, ref)}
                ms = time_ms(run, "cuda", 10, 3)
                parts = bwd_part_ms(run)
            regs = bwd_registers(log)
            print(json.dumps({
                "tool": "tc_variants", "variant": name, "kernel": "convlstm_backward",
                "shape": list(BWD_SHAPE), "dtype": "bfloat16", "ms": ms, "ms_by_part": parts,
                "max_abs_err": err, "registers_spills": sorted({tuple(v) for v in regs.values()}),
                "device": card, "power_limit_w": limit}), flush=True)


def main(argv: Optional[Sequence[str]] = ()) -> None:
    """The variants' lines; ``argv`` None reads the command line."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--backward", action="store_true",
                        help="kernel 3's bf16 variants at the 512x512 train step's shape")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tc_variants: no CUDA device (torch.cuda.is_available() is False)")
    card, limit = torch.cuda.get_device_name(0), bench.power_limit_w()
    if args.backward:
        main_backward(card, limit)
        return
    with tempfile.TemporaryDirectory(prefix="tc_variants_") as tmp:
        libs = build(Path(tmp))
        g = torch.Generator(device="cuda").manual_seed(0)
        for kernel, shape in CALLS:
            b, t, hgt, wid, ch = shape
            gx = (torch.randn((b, t, hgt, wid, 4 * ch), generator=g, device="cuda") * 0.5
                  ).to(torch.bfloat16)
            wh = (torch.randn((3, 3, ch, 4 * ch), generator=g, device="cuda") * 0.05
                  ).to(torch.bfloat16)
            h0 = torch.randn((b, hgt, wid, ch), generator=g, device="cuda") * 0.1
            c0 = torch.randn((b, hgt, wid, ch), generator=g, device="cuda") * 0.1
            cell = kernel == "convlstm_train_forward"
            plan = convlstm.recurrence_plan(kernel, *shape, torch.bfloat16, "stepwise_tc")
            ref = convlstm.convlstm_forward_ref(gx, wh, h0, c0, cell)[0].float()
            for name, (lib, log) in libs.items():
                err = float((call(lib, gx, wh, h0, c0, cell, plan).float() - ref).abs().max())
                ms = time_ms(lambda: call(lib, gx, wh, h0, c0, cell, plan), "cuda", 10, 3)
                regs = bf16_step_registers(log)
                print(json.dumps({
                    "tool": "tc_variants", "variant": name, "kernel": kernel, "shape": list(shape),
                    "dtype": "bfloat16", "plan": {"warpgroups": plan.warpgroups,
                                                  "cluster": plan.cluster,
                                                  "step_blocks": plan.step_blocks},
                    "ms": ms, "max_abs_err": err,
                    "registers_spills": sorted({tuple(v) for v in regs.values()}),
                    "device": card, "power_limit_w": limit}), flush=True)


if __name__ == "__main__":
    main(None)
