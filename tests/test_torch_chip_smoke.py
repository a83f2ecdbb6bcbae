"""CPU tests of chip_smoke.py's pure-Python helpers (the ptxas report, the
attention bounds, the delta band, the profiler's kernel groups, the case
tables, the kernel designs read from machine code, the launches each model
path must show and the llama param count), of bench_kernels.py's
choice of what to time, and of chip_smoke.py and bench_kernels.py
refusing to run without a card. They need no card: chip_smoke.py and
bench_kernels.py import only the standard library at module level."""

import dataclasses
import importlib.util
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _load("chip_smoke")

_FWD = ("_ZN45_GLOBAL__N__8f4ed862_12_flash_fwd_cu_5c297d6e21flash_fwd_bf16_"
        "kernelILi{d}EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfifi")
_DKV = ("_ZN45_GLOBAL__N__14df9a74_12_flash_bwd_cu_bfc9642125flash_bwd_dkv_"
        "bf16_kernelILi{d}EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16"
        "S5_ifi")


def _entry(mangled: str, regs: int, spill: int = 0) -> str:
    stack = f"{spill} bytes stack frame, {spill} bytes spill stores, " \
            f"{spill} bytes spill loads"
    return (f"ptxas info    : Compiling entry function '{mangled}' for "
            f"'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    {stack}\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers\n"
            f"ptxas info    : Compile time = 150.0 ms\n")


_DQ_WG = ("_ZN45_GLOBAL__N__14df9a74_12_flash_bwd_cu_bfc9642124flash_bwd_dq_"
          "bf16_kernelILi{d}EEEv14CUtensorMap_stS1_S1_S1_PK13__nv_bfloat16S4_"
          "PKfPfPS2_ifi")

# ptxas -v for the wgmma/TMA K1 and K3 at the four head dims, with the
# register counts an H100 build reported.
FWD_LOG = "".join(_entry(_FWD.format(d=d), r)
                  for d, r in ((128, 168), (64, 168), (32, 168), (16, 128)))
DKV_LOG = "".join(_entry(_DKV.format(d=d), r)
                  for d, r in ((128, 228), (64, 166), (32, 140), (16, 119)))
# A build of K3 at head_dim 128 that spilled, with ptxas's notes.
SPILLED_LOG = (
    "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async "
    "instructions are serialized due to insufficient register resources "
    f"for the function '{_DKV.format(d=128)}'\n"
    "ptxas info    : (C7508) Potential Performance Loss: 'setmaxnreg' "
    "ignored; unable to determine register count at entry.\n"
    + _entry(_DKV.format(d=128), 168, 248))


class TestPtxasReport:
    def test_new_kernels_at_every_head_dim(self):
        report = cs.ptxas_report([FWD_LOG, DKV_LOG])
        for kernel in ("flash_fwd_bf16_kernel", "flash_bwd_dkv_bf16_kernel"):
            for d in (16, 32, 64, 128):
                props = report[f"{kernel}<{d}>"]
                assert props["registers"].startswith("Used ")
                assert "0 bytes spill stores" in props["spill"]
        assert report["flash_bwd_dkv_bf16_kernel<128>"]["registers"] \
            == "Used 228 registers, used 1 barriers"
        assert cs.spilling_kernels(report, "bf16") == []

    def test_spill_and_notes_are_found(self):
        report = cs.ptxas_report([SPILLED_LOG])
        props = report["flash_bwd_dkv_bf16_kernel<128>"]
        assert "248 bytes spill stores" in props["spill"]
        assert props["notes"][0].startswith("C7512 ")
        assert report["ptxas"]["notes"][0].startswith("C7508 ")
        assert cs.spilling_kernels(report, "bf16") == [
            "flash_bwd_dkv_bf16_kernel<128>"]
        assert cs.spilling_kernels(report, "f32") == []

    def test_unknown_function_keeps_its_name(self):
        report = cs.ptxas_report([_entry("_Z10other_kernelv", 32)])
        assert report["_Z10other_kernelv"]["registers"].startswith("Used 32")


H100 = {"bf16": 989e12, "bytes": 3.35e12}


class TestAttentionBound:
    @pytest.mark.parametrize("shape,args,ms,by", [
        ((16, 12, 1024, 64), (), 0.0300, "bytes"),              # K1
        ((16, 12, 1024, 64), (4, 6, 2), 0.0522, "operations"),  # K3
        ((8, 8, 2048, 128), (), 0.0695, "operations"),          # K1
        ((8, 8, 2048, 128), (4, 6, 2), 0.1390, "operations"),   # K3
        # K2: 3 products; q, k, v, dO, O read, dq written; lse read and
        # delta written
        ((16, 12, 1024, 64), (3, 6, 2), 0.0455, "bytes"),
        ((8, 8, 2048, 128), (3, 6, 2), 0.1043, "operations"),
    ])
    def test_model_shapes(self, shape, args, ms, by):
        bound_ms, bound_by = cs.attention_bound(
            shape, 2, True, H100["bf16"], H100["bytes"], *args)
        assert round(bound_ms, 4) == ms and bound_by == by

    def test_causal_counts_the_pairs_it_computes(self):
        full, _ = cs.attention_bound((1, 1, 4096, 64), 2, False, 1e12, 1e18)
        half, _ = cs.attention_bound((1, 1, 4096, 64), 2, True, 1e12, 1e18)
        assert half == pytest.approx(full * 4097 / 8192)


class TestDeltaErr:
    """chip_smoke.delta_err: |delta - rowsum(dO * O)| over the row's sum
    of |dO * O|."""

    def _rows(self):
        gen = torch.Generator().manual_seed(0)
        do, o = (torch.randn(2, 3, 5, 16, generator=gen) for _ in range(2))
        # row (0, 0, 0) cancels: delta is about 0, its magnitude is not
        o[0, 0, 0] = 0.0
        o[0, 0, 0, :8] = do[0, 0, 0, 8:]
        o[0, 0, 0, 8:] = -do[0, 0, 0, :8]
        return do, o

    def test_same_sum_has_no_error(self):
        do, o = self._rows()
        assert cs.delta_err((do * o).sum(-1), do, o) == 0.0

    def test_band_is_taken_against_the_magnitude(self):
        do, o = self._rows()
        prod = do * o
        mag = prod.abs().sum(-1)
        assert abs(float(prod[0, 0, 0].sum())) < 1e-5 * float(mag[0, 0, 0])
        near = prod.sum(-1) + 0.5 * cs.TOL_DELTA * mag
        far = prod.sum(-1) + 2.0 * cs.TOL_DELTA * mag
        assert cs.delta_err(near, do, o) <= cs.TOL_DELTA
        assert cs.delta_err(far, do, o) > cs.TOL_DELTA

    def test_a_zero_row_must_give_zero(self):
        do, o = self._rows()
        o[1, 2, 4] = 0.0
        delta = (do * o).sum(-1)
        assert cs.delta_err(delta, do, o) == 0.0
        delta[1, 2, 4] = 1e-30
        assert cs.delta_err(delta, do, o) > cs.TOL_DELTA


class TestBenchKernels:
    def test_computes_delta_reads_the_wrapper_signature(self):
        bk = _load("bench_kernels")

        def this_tree(q, k, v, o, do, lse, causal, scale):
            pass

        def parent(q, k, v, do, lse, delta, causal, scale):
            pass

        assert bk.computes_delta(this_tree)
        assert not bk.computes_delta(parent)

    def test_this_tree_computes_delta(self):
        from ray_tpu_torch.ops import _kernels

        assert _load("bench_kernels").computes_delta(_kernels.flash_bwd_dq)


class TestKernelGroup:
    @pytest.mark.parametrize("name,group", [
        ("void (anonymous namespace)::flash_fwd_bf16_kernel<64>("
         "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, "
         "float*, int, float, int)", "K1"),
        ("void (anonymous namespace)::flash_bwd_dkv_bf16_kernel<128>("
         "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
         "float const*, float const*, __nv_bfloat16*, __nv_bfloat16*, int, "
         "float, int)", "K3"),
        ("void (anonymous namespace)::flash_bwd_dq_bf16_kernel<64>("
         "__nv_bfloat16 const*)", "K2"),
        (_FWD.format(d=128), "K1"),
        (_DKV.format(d=16), "K3"),
        ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTN", "matmul"),
    ])
    def test_groups(self, name, group):
        assert cs._kernel_group(name).startswith(group)


class TestCaseTables:
    def test_edge_cases_cover_the_tile_edges(self):
        seqs = {(shape[2], causal) for shape, causal in cs.EDGE_CASES}
        for s in (127, 129, 255, 257):
            assert (s, True) in seqs and (s, False) in seqs
        assert any(b * h == 1 for (b, h, _, _), _ in cs.EDGE_CASES)
        assert ((2, 4, 256, 128), False) in cs.EDGE_CASES
        # more blocks than an H100's 132 SMs, for K1 (128 rows a block)
        # and K3 (at most 128 keys a block)
        assert any(b * h * -(-s // 128) > 132
                   for (b, h, s, _), _ in cs.EDGE_CASES)

_DQ = ("_ZN45_GLOBAL__N__14df9a74_12_flash_bwd_cu_bfc9642124flash_bwd_dq_"
       "{t}_kernelILi{d}EEEvPKT_S4_S4_S4_PKfS6_PS2_ifi")


def _sass(mangled: str, *ops: str) -> str:
    """One function of ``cuobjdump -sass`` output issuing ``ops``."""
    body = "".join(f"        /*{i:04x}*/                   {op} ;"
                   f"                 /* 0x000fe20008000000 */\n"
                   for i, op in enumerate(("LDC R1, c[0x0][0x28]",) + ops))
    return (f"\t\tFunction : {mangled}\n"
            "\t.headerflags\t@\"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS "
            "EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)\"\n" + body +
            "        /*1000*/                   EXIT ;\n"
            "\t\t..........\n\n")


_HGMMA = "HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT, gsb0"
_TMA = "UTMALDG.3D [UR16], [UR6], desc[UR4]"
SASS = ("\nFatbin elf code:\n================\narch = sm_90a\n"
        "code version = [1,8]\nhost = linux\ncompile_size = 64bit\n\n"
        "\tcode for sm_90a\n"
        + "".join(_sass(_FWD.format(d=d), _TMA, _HGMMA)
                  for d in (16, 32, 64, 128))
        + "".join(_sass(_DQ_WG.format(d=d), _TMA, _HGMMA)
                  for d in (16, 32, 64, 128))
        + _sass(_DQ.format(t="f32", d=64), "FFMA R5, R6, R7, R5")
        + _sass("_Z12mma_sync_genv", "HMMA.16816.F32.BF16 R4, R8, R12, R4")
        + _sass(_DKV.format(d=64), _TMA, "HMMA.16816.F32.BF16 R4, R8, R12, R4",
                _HGMMA))


class TestDesigns:
    def test_designs_from_machine_code(self):
        designs = cs.sass_designs(SASS)
        assert {designs[f"flash_fwd_bf16_kernel<{d}>"]
                for d in (16, 32, 64, 128)} == {"wgmma+tma"}
        assert {designs[f"flash_bwd_dq_bf16_kernel<{d}>"]
                for d in (16, 32, 64, 128)} == {"wgmma+tma"}
        assert designs["flash_bwd_dq_f32_kernel<64>"] == "simt"
        assert designs["_Z12mma_sync_genv"] == "mma.sync"
        # a mix that no design names shows its instructions
        assert designs["flash_bwd_dkv_bf16_kernel<64>"] \
            == "HGMMA+HMMA+UTMALDG"

    def test_kernel_design_reads_the_bf16_instantiations(self):
        designs = cs.sass_designs(SASS)
        assert cs.kernel_design(designs, "flash_fwd") == "wgmma+tma"
        assert cs.kernel_design(designs, "flash_bwd_dq") == "wgmma+tma"
        designs["flash_fwd_bf16_kernel<16>"] = "mma.sync"
        assert cs.kernel_design(designs, "flash_fwd") == "mma.sync,wgmma+tma"


class TestBuildGate:
    def test_every_attention_kernel_must_be_wgmma_tma(self):
        assert set(cs.WGMMA_KERNELS) == {"flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkv"}


class TestWithoutCard:
    def test_chip_smoke_fails_without_card_or_repo(self, tmp_path):
        alone = tmp_path / "chip_smoke.py"
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
        for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, alone)):
            run = subprocess.run([sys.executable, str(script)], cwd=cwd,
                                 capture_output=True, text=True, timeout=120,
                                 env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
            assert run.returncode != 0
            assert '"ok": true' not in run.stdout

    def test_bench_kernels_fails_without_card(self):
        run = subprocess.run(
            [sys.executable, "bench_kernels.py"], cwd=REPO,
            capture_output=True, text=True, timeout=120,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert run.returncode == 1 and "no CUDA device" in run.stderr


class TestModelPaths:
    """The pure-Python helpers of the model phases: the launches each
    path must show, and the param count that the llama MFU divides by."""

    def test_expected_launches_per_config_and_remat(self):
        from ray_tpu_torch.models import (GPTConfig, LlamaConfig, MoEConfig,
                                          ViTConfig)

        def counts(cfg, train=True):
            got = cs.expected_launches(cfg.n_layers, cfg.remat, train)
            return (got["flash_fwd"], got["flash_bwd_dq"],
                    got["flash_bwd_dkv"])

        gpt = GPTConfig.gpt2_small()
        assert counts(gpt) == (24, 12, 12)
        assert counts(dataclasses.replace(gpt, remat=False)) == (12, 12, 12)
        assert counts(LlamaConfig.tpu_bench()) == (16, 16, 16)  # remat off
        assert counts(LlamaConfig()) == (12, 6, 6)               # remat on
        assert counts(ViTConfig.vit_b16()) == (24, 12, 12)
        assert counts(ViTConfig.vit_b16(), train=False) == (12, 0, 0)
        assert counts(MoEConfig()) == (8, 4, 4)

    @pytest.mark.parametrize("preset", ["tpu_bench", "tiny"])
    def test_llama_param_count_matches_the_params(self, preset):
        import jax

        from ray_tpu.models import llama as jllama
        from ray_tpu_torch.models import LlamaConfig

        cfg = getattr(LlamaConfig, preset)()
        shapes = jax.eval_shape(lambda: jllama.llama_init(
            jax.random.PRNGKey(0), getattr(jllama.LlamaConfig, preset)()))
        jax_count = sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))
        assert cs.llama_param_count(cfg) == jax_count
        if preset == "tpu_bench":
            # every param: embedding, untied head, 16 layers, norms
            assert jax_count == 245_924_864

    def test_vit_shape_is_vit_b16_attention(self):
        from ray_tpu_torch.models import ViTConfig

        cfg = ViTConfig.vit_b16()
        assert cs.VIT_SHAPE == (64, cfg.n_heads, cfg.num_patches + 1,
                                cfg.head_dim) == (64, 12, 197, 64)
        # 197 f32 rows are 788 bytes: off the 16-byte grid that TMA needs
        assert cs.VIT_SHAPE[2] * 4 % 16

    def test_model_shapes_are_each_paths_attention(self):
        from ray_tpu_torch.models import GPTConfig, LlamaConfig, MoEConfig

        gpt, llama = GPTConfig.gpt2_small(), LlamaConfig.tpu_bench()
        moe = MoEConfig()
        assert cs.MOE_SHAPE == (8, moe.n_heads, moe.max_seq_len,
                                moe.head_dim) == (8, 8, 1024, 64)
        assert cs.LLAMA_SHAPE == (8, llama.n_heads, 2048, llama.head_dim)
        assert cs.GPT2_SHAPE == (16, gpt.n_heads, 1024, gpt.head_dim)
        # both compare phases hold and time the kernels at each of them;
        # only ViT's attention is not causal
        assert cs.MODEL_SHAPES == [
            (cs.GPT2_SHAPE, True), (cs.LLAMA_SHAPE, True),
            (cs.VIT_SHAPE, False), (cs.MOE_SHAPE, True)]

    def test_record_routes_records_the_dispatch_and_restores(self):
        import torch

        from ray_tpu_torch.parallel import moe as pmoe

        gen = torch.Generator().manual_seed(0)
        x = torch.randn(32, 16, generator=gen)
        gate = torch.randn(16, 4, generator=gen)
        w1 = torch.randn(4, 16, 8, generator=gen)
        w2 = torch.randn(4, 8, 16, generator=gen)
        original, record = pmoe.top2_gating, []
        assert cs.record_routes(record) is original
        try:
            # a small capacity, so that some routes are dropped
            pmoe.moe_layer(x, gate, w1, w2, capacity_factor=0.5)
        finally:
            pmoe.top2_gating = original
        dispatch, _, _ = original(x @ gate, max(1, int(0.5 * 32 * 2 / 4)))
        assert len(record) == 1
        assert torch.equal(record[0], dispatch.any(-1))
        assert (record[0].sum(-1) < 2).any()
