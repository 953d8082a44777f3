#!/usr/bin/env python3
"""What the bf16 kernels' near-tie rule needs (``tc_blocks.cuh``
``WideRule``, the one rule of K1's checked forward, K3's forward and the
backward's recompute) on one CUDA card.

    python3 tools/torch_near_tie_variants.py [VARIANT ...]

Copies the kernel sources once per variant under
``build/near_tie_variants/<variant>/``, edits the copy's ``tc_blocks.cuh``
as the variant says (``VARIANTS``; ``forward_rule`` is the rule the
forwards had before they took the backward's), builds its
``fused_field_tc.cu`` (K1), ``field_bwd_tc.cu`` (K2) and ``spacenet_tc.cu``
(K3, both halves) each alone into a shared library, all in parallel, and
launches them through ctypes on phase 4's and phase 6's bf16 inputs: K2,
and K1's checked forward, on a real training step's performer and
background inputs (``chip_smoke.real_bwd_inputs``, M = 240,000) and on the
1024/512 background at the background inputs cut to M = 122,045; K3's
forward and backward on phase 6's seeded encodings for the performer with
time (M = 240,000) and the 1024/512 background (M = 122,045). For each,
per variant: the backward's pass-1 records and the forward's taps that are
not the k-order rounding of their layer (``chip_smoke.bwd_records_check``
and ``fwd_taps_check``, summed over the layers, and the activations
compared) and each half's ms per call (CUDA events, 5 calls after a
warm-up). Prints the card's ``name, power.limit`` first. Compare variants
only within one invocation.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "near_tie_variants")
NEAR_KS = "constexpr unsigned NEAR_KS = 8;"
ABS_KS = "constexpr unsigned ABS_KS = 8;"
VARIANTS = {
    "base": [],
    # the forwards' former rule (near_tie): NEAR float32 ulps of a tie, positive
# outputs only
    "forward_rule": [(NEAR_KS, NEAR_KS.replace("8", "0")), (ABS_KS, ABS_KS.replace("8", "0"))],
    # the ulp window grown with the k-steps, no window against the sums' scale
    "ulps_only": [(ABS_KS, ABS_KS.replace("8", "0"))],
    # half the window against the sums' scale
    "abs_half": [(ABS_KS, ABS_KS.replace("8", "4"))],
}


STEMS = ("fused_field_tc", "field_bwd_tc", "spacenet_tc")


def build(names: list) -> dict:
    """Edited copies of csrc/, K1's, K2's and K3's bf16 sources each built
    alone -> {name: (K1 library, K2 library, K3 library)}."""
    sys.path.insert(0, REPO)
    from stnerf_tpu_torch.kernels._build import CSRC, NVCC_FLAGS, SIGNATURES, find_nvcc

    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for name in names:
        d = os.path.join(OUT, name)
        shutil.copytree(CSRC, d)
        path = os.path.join(d, "tc_blocks.cuh")
        src = open(path).read()
        for text, repl in VARIANTS[name]:
            if text not in src:
                raise SystemExit(f"variant {name}: tc_blocks.cuh has no {text!r}")
            src = src.replace(text, repl)
        open(path, "w").write(src)
        procs[name] = [subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-shared", "-o", os.path.join(d, f"{stem}.so"),
             os.path.join(d, f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for stem in STEMS]
    libs = {}
    for name, ps in procs.items():
        pair = []
        for p, stem in zip(ps, STEMS):
            log = p.communicate()[0]
            if p.returncode != 0:
                raise SystemExit(f"variant {name}: nvcc failed on {stem}.cu:\n{log[-4000:]}")
            lib = ctypes.CDLL(os.path.join(OUT, name, f"{stem}.so"))
            for fn, argtypes in SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            pair.append(lib)
        libs[name] = tuple(pair)
    return libs


def launchers(k2_lib, k3_lib):
    """(K2, K3) launches through the C entry points of the libraries given
    (a variant's, or a checkout's whose wrappers take no workspace:
    ``tools/torch_ab_phases.py``) with a caller's workspace, as
    ``chip_smoke.bwd_records_check``'s ``launch``."""
    import torch

    from stnerf_tpu_torch.kernels import spacenet_vjp
    from stnerf_tpu_torch.kernels.fused_field import kernel_ints

    ptr = ctypes.c_void_p

    def outputs(f, a, b):
        return [torch.empty(s, dtype=torch.float32, device=a.device) for s in
                (f.weights.shape, f.biases.shape, tuple(a.shape), tuple(b.shape))]

    def k2(f, args, work):
        xyz, ids, dir_enc, d_rgb, d_sigma, flags = args
        frags, offsets = f.tc
        outs = outputs(f, xyz, dir_enc)
        err = k2_lib.stnerf_field_bwd_tc(
            *(ptr(t.data_ptr()) for t in (xyz, ids, dir_enc, d_rgb, d_sigma)),
            ptr(None if flags is None else flags.data_ptr()), ptr(f.weights.data_ptr()),
            ptr(frags.data_ptr()), ptr(f.biases.data_ptr()), offsets.ctypes.data_as(ptr),
            *(ptr(o.data_ptr()) for o in outs), ptr(work.data_ptr()),
            *kernel_ints(f, xyz.shape[1], dir_enc.shape[0]), f.weights.numel(),
            f.biases.numel(), ptr(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"K2 variant launch failed: CUDA error {err}")

    def k3(f, args, work):
        pos, dir_enc, time_enc, d_rgb, d_sigma = args[:5]
        active = args[5] if len(args) > 5 else None
        frags, offsets = f.tc
        ints, time_ptr, active_ptr = spacenet_vjp._kernel_args(f, pos, dir_enc, time_enc, active)
        outs = outputs(f, pos, dir_enc)
        err = k3_lib.stnerf_spacenet_bwd_tc(
            ptr(pos.data_ptr()), ptr(dir_enc.data_ptr()), time_ptr, ptr(d_rgb.data_ptr()),
            ptr(d_sigma.data_ptr()), ptr(f.weights.data_ptr()), ptr(frags.data_ptr()),
            ptr(f.biases.data_ptr()), offsets.ctypes.data_as(ptr), active_ptr,
            *(ptr(o.data_ptr()) for o in outs), ptr(work.data_ptr()), *ints,
            f.weights.numel(), f.biases.numel(), ptr(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"K3 variant launch failed: CUDA error {err}")

    return k2, k3


def fwd_launchers(k1_lib, k3_lib):
    """(K1's checked forward, K3's forward) launches with taps through the
    C entry points of the libraries given, as ``chip_smoke.fwd_taps``'s
    ``launch``."""
    import torch

    from stnerf_tpu_torch.kernels import spacenet_vjp
    from stnerf_tpu_torch.kernels.fused_field import kernel_ints

    ptr = ctypes.c_void_p

    def k1(f, args, taps):
        xyz, ids, dir_enc, flags = args
        frags, offsets = f.tc
        out = torch.empty((4, xyz.shape[1]), dtype=torch.float32, device=xyz.device)
        err = k1_lib.stnerf_fused_field_tc(
            *(ptr(t.data_ptr()) for t in (xyz, ids, dir_enc)),
            ptr(None if flags is None else flags.data_ptr()), ptr(f.weights.data_ptr()),
            ptr(frags.data_ptr()), ptr(f.biases.data_ptr()), ptr(f.tc_norms.data_ptr()),
            offsets.ctypes.data_as(ptr), ptr(out.data_ptr()),
            *kernel_ints(f, xyz.shape[1], dir_enc.shape[0]), 1,
            ptr(None if taps is None else taps.data_ptr()),
            ptr(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"K1 variant launch failed: CUDA error {err}")

    def k3(f, args, taps):
        pos, dir_enc, time_enc = args[:3]
        active = args[3] if len(args) > 3 else None
        frags, offsets = f.tc
        ints, time_ptr, active_ptr = spacenet_vjp._kernel_args(f, pos, dir_enc, time_enc, active)
        out = torch.empty((4, pos.shape[1]), dtype=torch.float32, device=pos.device)
        err = k3_lib.stnerf_spacenet_fwd_tc(
            ptr(pos.data_ptr()), ptr(dir_enc.data_ptr()), time_ptr, ptr(f.weights.data_ptr()),
            ptr(frags.data_ptr()), ptr(f.biases.data_ptr()), ptr(f.tc_norms.data_ptr()),
            offsets.ctypes.data_as(ptr), active_ptr, ptr(out.data_ptr()), *ints,
            ptr(None if taps is None else taps.data_ptr()),
            ptr(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"K3 forward variant launch failed: CUDA error {err}")

    return k1, k3


def main():
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from stnerf_tpu_torch.kernels import field_vjp, spacenet_vjp
    from stnerf_tpu_torch.kernels._build import load_library
    from stnerf_tpu_torch.kernels.fused_field import pack_field, prepare_kernel_params_planar
    from stnerf_tpu_torch.models import LayeredSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    load_library()  # the tree's build: block and workspace queries
    libs = build(names)
    real = cs.real_bwd_inputs(device)
    m_e = 2000 * 61 + 45
    bg = real["background"]
    cut = (*(a[..., :m_e].contiguous() for a in bg[:5]),
           None if bg[5] is None else bg[5][:-(-m_e // 64)].contiguous())
    model = cs.make_model(LayeredSpec.from_cfg(cs.taekwondo_cfg()), device)
    xwide = cs.widths_model(cs.taekwondo_cfg(), cs.XWIDE_WIDTHS, device)
    vp = cs.make_model(LayeredSpec.from_cfg(cs.view_pose_cfg(), camera_num=8), device)
    vp_xwide = cs.widths_model(cs.view_pose_cfg(), cs.XWIDE_WIDTHS, device, camera_num=8)
    x = cs._encoded_inputs(device, 2000 * 120, cs.SEED + 5)
    xe = cs._encoded_inputs(device, m_e, cs.SEED + 7)

    def k3_args(net, enc):
        f = pack_field(prepare_kernel_params_planar(net, torch.bfloat16), (), net.spec, None,
                       "bfloat16")
        return f, (enc["pos"], enc["dir"], enc["time"] if net.spec.use_time else None,
                   enc["d_rgb"], enc["d_sigma"])

    cases = [("field_bwd", "performer_lerp",
              cs.pack_dtype(model.layers_fine[0], model.motion[0], "lerp", "bfloat16"),
              real["performer"]),
             ("field_bwd", "background", cs.pack_dtype(model.bkgd_fine, None, None, "bfloat16"),
              bg),
             ("field_bwd", "xwide_background",
              cs.pack_dtype(xwide.bkgd_fine, None, None, "bfloat16"), cut),
             ("spacenet_bwd", "performer_time", *k3_args(vp.layers_fine[0], x)),
             ("spacenet_bwd", "xwide_background", *k3_args(vp_xwide.bkgd_fine, xe))]
    def total(counts):
        return {"not_k_order": sum(v for k, v in counts.items() if k != "outputs"),
                "outputs": counts["outputs"]}

    for kind, case, f, args in cases:
        row = {"kernel": kind, "case": case, "m": int(args[0].shape[1])}
        nbytes = (field_vjp.tc_bwd_launch(f, args[0].shape[1], args[2].shape[0])
                  ["workspace_bytes"] if kind == "field_bwd"
                  else spacenet_vjp.tc_workspace_bytes(f, *args[:3]))
        work = torch.empty(nbytes, dtype=torch.uint8, device=device)
        # the forward of the same field on the same inputs: K1's checked
        # forward beside K2, K3's forward beside its backward
        if kind == "field_bwd":
            fwd_kind, fwd_args = "fused_field", (*args[:3], args[5])
        else:
            fwd_kind, fwd_args = "spacenet_fwd", args[:3]
        for name in names:
            k1_lib, k2_lib, k3_lib = libs[name]
            k2, k3 = launchers(k2_lib, k3_lib)
            k1_fwd, k3_fwd = fwd_launchers(k1_lib, k3_lib)
            launch = k2 if kind == "field_bwd" else k3
            fwd = k1_fwd if kind == "field_bwd" else k3_fwd
            row[name] = {"bwd": {**total(cs.bwd_records_check(kind, f, args, launch)),
                                 "ms": cs.cuda_ms(lambda: launch(f, args, work), 5)},
                         "fwd": {**total(cs.fwd_taps_check(fwd_kind, f, fwd_args, fwd)),
                                 "ms": cs.cuda_ms(lambda: fwd(f, fwd_args, None), 5)}}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
