"""CPU tests of chip_smoke.py's pure-Python helpers (the ptxas report, the
attention bounds, the delta band, the profiler's kernel groups, the case
tables, the kernel designs read from machine code, the launches each model
path must show and the llama param count), of bench_kernels.py's
choice of what to time, and of chip_smoke.py and bench_kernels.py
refusing to run without a card. They need no card: chip_smoke.py and
bench_kernels.py import only the standard library at module level."""

import dataclasses
import importlib
import importlib.util
import math
import os
import shutil
import signal
import subprocess
import sys
import time

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
tu = importlib.import_module("ray_tpu_torch._private.test_utils")

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


class TestControlPlanePhases:
    """The pure-Python parts of the heads_over_limit, processor and
    runtime phases: which heads are compared around the chunk
    boundaries, and the pool actor's launch and pid check."""

    def test_over_limit_cases_pass_the_grid_limit_in_two_chunks(self):
        from ray_tpu_torch.ops import _kernels

        for (b, h, s, d), _, _ in cs.OVER_LIMIT_CASES:
            assert b * h > 65535  # gridDim.y's cap
            assert len(_kernels.head_chunks(b * h)) == 2
        assert [c[0] for c in cs.OVER_LIMIT_CASES] == [
            (4097, 16, 64, 64), (5462, 12, 197, 64)]
        assert any(backward for *_, backward in cs.OVER_LIMIT_CASES)

    @pytest.mark.parametrize("bh,chunk", [(65552, 65532), (200003, 65532),
                                          (10, 4), (3, 65532)])
    def test_boundary_heads(self, bh, chunk):
        heads = cs.boundary_heads(bh, chunk)
        assert heads == sorted(set(heads))
        assert all(0 <= x < bh for x in heads)
        assert {0, bh - 1} <= set(heads)
        for edge in range(chunk, bh, chunk):
            # the last two heads of a chunk and the first two of the next
            assert {edge - 2, edge - 1, edge, edge + 1} & set(range(bh)) \
                <= set(heads)
        assert len(heads) <= 4 + 4 * (bh // chunk)

    EXPECTED = {"flash_fwd": 96, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

    def _rows(self, pids, calls, launches, dq=0, drop=None):
        rows = [{"stage_pid": p, "stage_call": c, "launches_flash_fwd": n,
                 "launches_flash_bwd_dq": dq, "launches_flash_bwd_dkv": 0}
                for p, c, n in zip(pids, calls, launches)]
        for row in rows if drop else ():
            del row[drop]
        return rows

    def test_worker_launches_accepted(self):
        rows = self._rows([7] * 16, [1] * 16, [96] * 16)
        assert cs.check_worker_launches(rows, 3, self.EXPECTED) == {
            "pid": 7, "calls": 1, **self.EXPECTED}

    @pytest.mark.parametrize("pids,calls,launches,dq,drop", [
        ([3, 3], [1, 1], [96, 96], 0, None),      # ran in the driver
        ([7, 8], [1, 1], [96, 96], 0, None),      # two pool actors
        ([7, 7], [1, 2], [96, 96], 0, None),      # two calls: split batch
        ([7, 7], [1, 1], [0, 0], 0, None),        # the plain path, no K1
        ([7, 7], [1, 1], [96, 95], 0, None),      # rows disagree
        ([7, 7], [1, 1], [96, 96], 12, None),     # K2 ran in the actor
        ([7, 7], [1, 1], [96, 96], 0,             # K3 not reported
         "launches_flash_bwd_dkv"),
    ])
    def test_worker_launches_rejected(self, pids, calls, launches, dq, drop):
        with pytest.raises(AssertionError):
            cs.check_worker_launches(
                self._rows(pids, calls, launches, dq, drop), 3,
                self.EXPECTED)

    def test_copy_dirs_use_the_copy_prefix(self, tmp_path):
        """copy_dirs lists only the given head's own directories, those
        that exist; the head's store carries the copy's prefix."""
        from types import SimpleNamespace

        from ray_tpu_torch._private.config import shm_prefix

        session, store = tmp_path / "session", tmp_path / "store"
        node = SimpleNamespace(session_dir=str(session),
                               store_dir=str(store))
        (tmp_path / "other").mkdir()  # another head's: never listed
        assert cs.copy_dirs(node) == []
        session.mkdir()
        store.mkdir()
        assert cs.copy_dirs(node) == [str(session), str(store)]
        assert shm_prefix().startswith("rtt_")

    @pytest.mark.parametrize("a,b,want", [
        ("abc", "abc", None), ("abc", "abd", 2), ("ab", "abc", 2),
        ("", "x", 0)])
    def test_first_difference(self, a, b, want):
        assert cs.first_difference(a, b) == want


class TestTrainDpPhase:
    """The pure-Python parts of the train_dp phase: the digest that holds
    the checkpoint against the worker's params, and the checks of the
    worker's report."""

    def _params(self):
        import torch

        gen = torch.Generator().manual_seed(0)
        return {"embed": torch.randn(8, 4, generator=gen).bfloat16(),
                "lnf": torch.ones(4),
                "layers": [{"w": torch.randn(4, 4, generator=gen)}]}

    def test_digest_follows_the_bytes(self):
        import torch

        params = self._params()
        copy = {"embed": params["embed"].clone(),
                "lnf": params["lnf"].clone(),
                "layers": [{"w": params["layers"][0]["w"].clone()}]}
        assert cs.state_digest(params) == cs.state_digest(copy)
        copy["embed"][0, 0] += 1
        assert cs.state_digest(params) != cs.state_digest(copy)
        # the same values in another dtype are another state
        as_f32 = dict(params, embed=params["embed"].float())
        assert cs.state_digest(params) != cs.state_digest(as_f32)
        assert torch.equal(as_f32["embed"].bfloat16(), params["embed"])

    def test_digest_survives_a_checkpoint(self, tmp_path):
        from ray_tpu_torch.train import Checkpoint

        params = self._params()
        loaded = Checkpoint.from_state({"params": params, "step": 5},
                                       str(tmp_path)).to_state()
        assert cs.state_digest(loaded["params"]) == cs.state_digest(params)

    LAUNCHES = {"flash_fwd": 120, "flash_bwd_dq": 60, "flash_bwd_dkv": 60}

    def _report(self, world=1, **rank_changes):
        ranks = [{"cuda_visible_devices": str(r), "gpu_ids": [r],
                  "device_count": 1, "pid": 11 + r, "digest": "d",
                  "collective_allreduce": {
                      "type": "Tensor", "device": "cuda:0",
                      "sum": world * (world + 1) / 2},
                  "launches": dict(self.LAUNCHES)} for r in range(world)]
        ranks[-1].update(rank_changes)
        return {"backend": "nccl", "world": world, "ranks": ranks,
                "losses": [11.0, 10.5, 10.0, 9.6, 9.2]}

    REFERENCE = [11.0, 10.5, 10.0, 9.6, 9.2, 8.9]

    @pytest.mark.parametrize("world", [1, 4])
    def test_report_accepted(self, world):
        got = cs.train_dp_checks(self._report(world), self.REFERENCE, 3, 5)
        assert all(got["checks"].values()), got
        assert got["bit_identical"]
        assert got["expected_launches"] == self.LAUNCHES

    def test_losses_within_band_not_identical(self):
        report = dict(self._report(), losses=[11.0, 10.5, 10.0, 9.6, 9.25])
        got = cs.train_dp_checks(report, self.REFERENCE, 3, 5)
        assert got["checks"]["losses_in_band"] and not got["bit_identical"]

    @pytest.mark.parametrize("world,change,failed", [
        (1, {"cuda_visible_devices": ""}, "pinned"),
        (1, {"gpu_ids": []}, "pinned"),
        (1, {"device_count": 2}, "pinned"),
        (2, {"gpu_ids": [0], "cuda_visible_devices": "0"}, "pinned"),
        (1, {"collective_allreduce": {"type": "ndarray", "device": "cpu",
                                      "sum": 1.0}}, "collective"),
        (2, {"collective_allreduce": {"type": "Tensor", "device": "cuda:0",
                                      "sum": 2.0}}, "collective"),
        (1, {"launches": {"flash_fwd": 24, "flash_bwd_dq": 12,
                          "flash_bwd_dkv": 12}}, "launches"),
        (1, {"launches": {"flash_fwd": 60, "flash_bwd_dq": 60,
                          "flash_bwd_dkv": 60}}, "launches"),  # remat off
        (1, {"pid": 3}, "other_process"),
        (2, {"pid": 11}, "other_process"),
        (2, {"digest": "e"}, "ranks_agree"),
    ])
    def test_rank_report_rejected(self, world, change, failed):
        got = cs.train_dp_checks(self._report(world, **change),
                                 self.REFERENCE, 3, 5)
        assert not got["checks"][failed], got

    @pytest.mark.parametrize("change,failed", [
        ({"backend": "gloo"}, "nccl"),
        ({"losses": [11.0, 10.5, 10.0, 9.6, float("nan")]},
         "losses_finite"),
        ({"losses": [11.0, 10.5, 10.0, 9.6, 9.5]}, "losses_in_band"),
        ({"losses": [11.0, 10.5, 10.0, 9.6]}, "losses_in_band"),
        ({"world": 2}, "pinned"),
    ])
    def test_report_rejected(self, change, failed):
        got = cs.train_dp_checks(dict(self._report(), **change),
                                 self.REFERENCE, 3, 5)
        assert not got["checks"][failed], got

    def test_launches_of_five_remat_steps(self):
        assert cs.TRAIN_DP_STEPS == 5
        got = cs.train_dp_checks(self._report(), self.REFERENCE, 3, 5)
        assert got["expected_launches"] == {
            "flash_fwd": 120, "flash_bwd_dq": 60, "flash_bwd_dkv": 60}
        # the band is no looser than train_vs_cpu's bf16 loss band
        bf16 = dict((d, t) for d, _, t in cs.VS_CPU_RUNS)["bfloat16"]
        assert cs.TOL_TRAIN_DP_LOSS <= bf16["loss"]


class TestTrainFeedPhase:
    """The pure-Python parts of the train_feed phase: the seeded data,
    and the checks of the worker's report."""

    def test_feed_data_is_seeded_and_shaped(self):
        from ray_tpu_torch.models import ViTConfig

        cfg = ViTConfig.tiny()
        images, labels = cs.feed_data(cfg, 3, 4, 11)
        again, again_labels = cs.feed_data(cfg, 3, 4, 11)
        assert images.shape == (12, 32, 32, 3) and images.dtype == "float32"
        assert labels.shape == (12,) and labels.dtype == "int64"
        assert (images == again).all() and (labels == again_labels).all()
        assert 0 <= labels.min() and labels.max() < cfg.num_classes
        assert not (cs.feed_data(cfg, 3, 4, 12)[0] == images).all()

    def test_vit_b16_dataset_size(self):
        from ray_tpu_torch.models import ViTConfig

        cfg = ViTConfig.vit_b16()
        n = cs.FEED_BATCHES * cs.FEED_BATCH
        assert (cs.FEED_BATCHES, cs.FEED_BATCH) == (6, 64)
        # f32 224x224x3 images: about 231 MB in the store
        assert round(n * cfg.image_size ** 2 * cfg.channels * 4 / 1e6) == 231

    STEP = {"flash_fwd": 24, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}
    REFERENCE = [7.1, 7.0, 6.9, 6.8, 6.7, 6.6]

    def _report(self, **changes):
        report = {
            "pid": 11, "cuda_visible_devices": "0", "device_count": 1,
            "losses": list(self.REFERENCE),
            "launches": {k: 5 * v for k, v in self.STEP.items()},
            "arrived": [{"devices": ["cuda:0"], "equal": True}] * 6,
            "traced_step": {"kernels": dict(self.STEP)},
            "memory_stats": {"peak_bytes_in_use": 9},
            "max_memory_allocated": 9}
        report.update(changes)
        return report

    def test_report_accepted(self):
        got = cs.train_feed_checks(self._report(), self.REFERENCE, 3, 5)
        assert all(got["checks"].values()), got
        assert got["expected_launches"] == {
            "flash_fwd": 120, "flash_bwd_dq": 60, "flash_bwd_dkv": 60}

    @pytest.mark.parametrize("change,failed", [
        ({"pid": 3}, "other_process"),
        ({"cuda_visible_devices": ""}, "pinned"),
        ({"device_count": 0}, "pinned"),
        ({"launches": {"flash_fwd": 24, "flash_bwd_dq": 12,
                       "flash_bwd_dkv": 12}}, "launches"),
        ({"arrived": [{"devices": ["cpu"], "equal": True}] * 6},
         "arrived_on_card"),
        ({"arrived": [{"devices": ["cuda:0"], "equal": True}] * 5
          + [{"devices": ["cuda:0"], "equal": False}]}, "arrived_equal"),
        ({"arrived": [{"devices": ["cuda:0"], "equal": True}] * 5},
         "arrived_equal"),
        ({"losses": [7.1, 7.0, 6.9, 6.8, 6.7, 6.6000001]}, "losses_equal"),
        ({"losses": [7.1, 7.0, 6.9, 6.8, 6.7, float("nan")]},
         "losses_equal"),
        ({"traced_step": {"kernels": {"flash_fwd": 24, "flash_bwd_dq": 0,
                                      "flash_bwd_dkv": 0}}},
         "trace_names_kernels"),
        ({"memory_stats": {}}, "memory_stats"),
        ({"memory_stats": {"peak_bytes_in_use": 8}}, "memory_stats"),
    ])
    def test_report_rejected(self, change, failed):
        got = cs.train_feed_checks(self._report(**change), self.REFERENCE,
                                   3, 5)
        assert not got["checks"][failed], got


class TestDagFusedPhase:
    """The pure-Python parts of the dag_fused phase: the slice's padding,
    the greedy loop, and the checks of its rows."""

    def test_left_pad_is_the_stages_padding(self):
        import numpy as np

        from ray_tpu_torch.llm import GPTInferenceStage, TokenizeStage
        from ray_tpu_torch.models import GPTConfig

        cfg = GPTConfig.tiny()
        tokens = TokenizeStage(max_length=cfg.max_seq_len)(
            {"prompt": cs._prompts(3, 20, 60)})["tokens"]
        seen = []

        class Spy(GPTInferenceStage):
            def _decode(self, toks):
                seen.append(toks.numpy().copy())
                return torch.zeros((toks.shape[0], 1), dtype=torch.long)

        Spy(config=cfg, max_new_tokens=1, device="cpu")({"tokens": tokens})
        got = cs.left_pad(tokens, 64, cfg.vocab_size)
        assert got.dtype == np.int64 and (got == seen[0]).all()
        assert (cs.left_pad([[1, 2, 3]], 2, 10) == [[2, 3]]).all()

    def test_greedy_run_slides_the_window(self):
        calls = []

        def step(toks):
            calls.append(toks.clone())
            return toks[:, -1] + 1

        news = cs.greedy_run(step, torch.tensor([[0, 5], [1, 9]]), 3)
        assert news.tolist() == [[6, 7, 8], [10, 11, 12]]
        assert calls[-1].tolist() == [[6, 7], [10, 11]]

    def test_greedy_dag_on_the_cpu_route(self):
        from ray_tpu_torch.models import GPTConfig, gpt_forward, gpt_init

        cfg = dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32)
        params = gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
        dag = cs.greedy_dag(params, cfg)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                               generator=torch.Generator().manual_seed(1))
        want = gpt_forward(params, tokens, cfg)[:, -1].argmax(-1)
        fused = dag.compile_fused(jit=True)
        assert torch.equal(fused(tokens), want) and fused.graphs == {}

    def _rows(self):
        step = {"flash_fwd": 12}
        launches = {"flash_fwd": 96, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        return [
            {"batch": 16, "seq": 1024, "steps": 8, "graphs": 1,
             "per_replay_launches": dict(step), "profiled_k1": 12,
             "empty_traces": 0,
             "launches": dict(launches), "tokens_equal_eager_dag": True,
             "tokens_equal_slice": True},
            {"batch": 1, "seq": 128, "steps": 8, "graphs": 2,
             "per_replay_launches": dict(step), "profiled_k1": 12,
             "empty_traces": 1,
             "launches": dict(launches), "tokens_equal_eager_dag": True}]

    def test_rows_accepted(self):
        assert cs.DAG_SIZES == [(16, 1024), (1, 128)]
        assert cs.dag_checks(self._rows(), 12) == []

    @pytest.mark.parametrize("row,change", [
        (0, {"per_replay_launches": {}}),
        (1, {"per_replay_launches": {"flash_fwd": 24}}),
        (0, {"profiled_k1": 0}),
        (1, {"launches": {"flash_fwd": 0, "flash_bwd_dq": 0,
                          "flash_bwd_dkv": 0}}),
        (0, {"launches": {"flash_fwd": 96, "flash_bwd_dq": 8,
                          "flash_bwd_dkv": 0}}),
        (0, {"tokens_equal_slice": False}),
        (1, {"tokens_equal_eager_dag": False}),
        (1, {"graphs": 1}),
    ])
    def test_rows_rejected(self, row, change):
        rows = self._rows()
        rows[row].update(change)
        assert len(cs.dag_checks(rows, 12)) == 1

    def test_profiler_count_failure_names_the_counts(self):
        rows = self._rows()
        rows[0].update(profiled_k1=0, empty_traces=3)
        assert cs.dag_checks(rows, 12) == [
            "16x1024: profiler K1 count 0, want 12 (3 empty traces)"]

    def test_the_slices_bucket_must_run(self):
        rows = self._rows()
        del rows[0]["tokens_equal_slice"]
        assert cs.dag_checks(rows, 12) == ["the slice's bucket was not run"]


class TestTraceSummary:
    """What the phases read from a torch.profiler Chrome trace."""

    @pytest.mark.parametrize("intervals,want", [
        ([], 0.0), ([(0, 2)], 2.0), ([(0, 2), (1, 3)], 3.0),
        ([(0, 1), (2, 3)], 2.0), ([(2, 3), (0, 5)], 5.0),
        ([(0, 4), (1, 2), (3, 6)], 6.0)])
    def test_union_length(self, intervals, want):
        assert cs.union_length(intervals) == want

    def test_overlap_share(self):
        assert cs.overlap_share([], [(0, 1)]) is None
        assert cs.overlap_share([(0, 10)], []) == 0.0
        assert cs.overlap_share([(0, 10)], [(2, 4), (3, 6), (9, 20)]) \
            == pytest.approx(0.5)
        assert cs.overlap_share([(0, 2), (4, 6)], [(1, 5)]) == 0.5

    def test_trace_summary(self, tmp_path):
        import json

        def ev(cat, name, ts, dur, **args):
            return {"ph": "X", "cat": cat, "name": name, "ts": ts,
                    "dur": dur, "args": args}

        events = [
            ev("kernel", "void (anonymous namespace)::flash_fwd_bf16_kernel"
               "<64>(CUtensorMap_st)", 0, 10),
            ev("kernel", "flash_fwd_bf16_kernel<64>", 20, 10),
            ev("kernel", "flash_bwd_dq_bf16_kernel<64>", 40, 10),
            ev("kernel", "flash_bwd_dkv_bf16_kernel<64>", 60, 10),
            ev("kernel", "ampere_bf16_gemm", 70, 30),
            ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 5, 20,
               bytes=1000),
            ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 90, 5,
               bytes=4),
            ev("cpu_op", "aten::copy_", 0, 100)]
        path = tmp_path / "t.pt.trace.json"
        path.write_text(json.dumps({"traceEvents": events}))
        assert cs.trace_file(str(tmp_path)) == str(path)
        got = cs.trace_summary(str(path))
        assert got["kernels"] == {"flash_fwd": 2, "flash_bwd_dq": 1,
                                  "flash_bwd_dkv": 1}
        assert got["gemm_launches"] == 1
        assert got["htod_copies"] == 1 and got["htod_bytes"] == 1000
        assert got["htod_ms"] == pytest.approx(0.02)
        assert got["htod_overlap_share"] == pytest.approx(0.5)
        assert got["kernel_busy_ms"] == pytest.approx(0.07)
        assert got["device_events"] == 7

    @pytest.mark.parametrize("device_events,runs,kept,empty", [
        ([5], 1, 5, 0),
        ([0, 0, 5], 3, 5, 2),
        ([0, 3], 2, 3, 1),
        ([0, 0, 0, 5], 3, 0, 3),
    ])
    def test_take_trace_retakes_only_empty_traces(
            self, monkeypatch, tmp_path, device_events, runs, kept, empty):
        takes, calls = iter(device_events), []

        def summary(path):
            assert path.endswith(".pt.trace.json")
            return {"kernels": {}, "device_events": next(takes)}

        monkeypatch.setattr(cs, "trace_summary", summary)
        got = cs.take_trace(lambda: calls.append(1), dir=str(tmp_path))
        assert cs.TRACE_TAKES == 3 and len(calls) == runs
        assert got["device_events"] == kept and got["empty_traces"] == empty
        assert os.listdir(tmp_path) == []


class TestParallelPhase:
    """The parallel phase's host-side helpers: the launches each rank must
    show, the bytes each collective must move, the transport report, and
    the checks over the ranks' rows."""

    def test_per_rank_launch_expectations(self):
        # tp and fsdp run every layer's attention on each rank (half the
        # heads or half the rows): the remat step's 24/12/12, 3 steps.
        want = {"flash_fwd": 72, "flash_bwd_dq": 36, "flash_bwd_dkv": 36}
        assert cs.parallel_expected_launches("tp") == want
        assert cs.parallel_expected_launches("fsdp") == want
        assert cs.parallel_expected_launches("ulysses") == {
            "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
        # 6 blocks a stage x 4 microbatches; 1F1B runs each stage's
        # forward again for its backward.
        assert cs.parallel_expected_launches("gpipe") == {
            "flash_fwd": 24, "flash_bwd_dq": 24, "flash_bwd_dkv": 24}
        assert cs.parallel_expected_launches("1f1b") == {
            "flash_fwd": 48, "flash_bwd_dq": 24, "flash_bwd_dkv": 24}

    @pytest.fixture(scope="class")
    def pool(self):
        from ray_tpu_torch.parallel.launch import RankPool

        with RankPool(2, "cpu", timeout=120) as pool:
            yield pool

    @pytest.mark.parametrize("remat", [True, False])
    def test_tp_bytes_reckoning_matches_a_tp_step(self, pool, remat):
        import torch_parallel_ranks as ranks
        from ray_tpu_torch.models import GPTConfig

        fields = {"vocab_size": 512, "d_model": 64, "n_heads": 4,
                  "n_layers": 2, "d_ff": 128, "max_seq_len": 128,
                  "remat": remat}
        (traffic, _), _ = pool.run(ranks.step_traffic, fields,
                                   {"dp": 1, "tp": 2}, "tp", 4, 48, 2)
        cfg = dataclasses.replace(GPTConfig(**fields), dtype=torch.float32)
        assert set(traffic) == {"all_reduce"}
        assert traffic["all_reduce"]["bytes"] == \
            2 * cs.tp_all_reduce_bytes(cfg, 4, 48)
        # 192 rows: the loss's chunk is 64 (a power of two dividing them);
        # the remat recompute takes the forward's sums back and sends
        # nothing.
        assert cs.tp_all_reduce_bytes(cfg, 4, 48) == \
            (4 * 2 + 2) * 4 * 48 * 64 * 4 + 3 * 3 * 64 * 4

    def test_fsdp_bytes_reckoning_matches_an_fsdp_step(self, pool):
        import torch_parallel_ranks as ranks

        fields = {"vocab_size": 512, "d_model": 64, "n_heads": 4,
                  "n_layers": 2, "d_ff": 128, "max_seq_len": 128}
        (traffic, params_bytes), _ = pool.run(
            ranks.step_traffic, fields, {"dp": 1, "fsdp": 2}, "fsdp", 4, 32,
            3)
        want = cs.fsdp_bytes(params_bytes, 2)
        assert {op: traffic[op]["bytes"] for op in want} == \
            {op: 3 * n for op, n in want.items()}

    def test_per_step_and_transports(self):
        staged = {"ppermute": {"calls": 8, "bytes": 800,
                               "transports": ["gloo, host-staged"]}}
        plain = {"all_reduce": {"calls": 6, "bytes": 600,
                                "transports": ["gloo"]}}
        assert cs.per_step(plain, 3) == {"all_reduce": {
            "calls_per_step": 2.0, "bytes_per_step": 200.0,
            "transports": ["gloo"]}}
        ranks = [{"tp": plain, "gpipe": staged}, {"tp": plain,
                                                  "gpipe": staged}]
        assert cs.transports(ranks) == {"all_reduce": ["gloo"],
                                        "ppermute": ["gloo, host-staged"]}

    def _rows(self):
        from ray_tpu_torch.models import GPTConfig

        tp_bytes = cs.PAR_STEPS * cs.tp_all_reduce_bytes(
            GPTConfig.gpt2_small(), cs.PAR_BATCH, cs.PAR_SEQ)
        fsdp = {op: n * cs.PAR_STEPS
                for op, n in cs.fsdp_bytes(1000, cs.PAR_RANKS).items()}

        controls = {"tp": {"doubled": 1.0, "wqkv_contiguous_blocks": 1.4,
                           "f_sums_dropped": 0.6},
                    "fsdp": {"doubled": 1.0}}

        def train(kind, traffic):
            return [{"pid": 10 + r, "launches":
                     cs.parallel_expected_launches(kind),
                     "losses": [6.0, 5.5, 5.0], "moments_sharded": True,
                     "traffic": traffic, "params_bytes": 1000,
                     **({"param_errs": [4e-2], "param_move_errs": [0.1],
                         "grad_errs": [1e-2, 2e-2],
                         "grad_control_errs": controls[kind]}
                        if r == 0 else {})}
                    for r in range(cs.PAR_RANKS)]

        def pp(kind):
            return [{"launches": cs.parallel_expected_launches(kind),
                     "grad_errs": [1e-2], "loss": 1.0, "ref_loss": 1.0}
                    for _ in range(cs.PAR_RANKS)]

        def family(path):
            fam, _, b, s = cs.PAR_FAMILIES[path]
            cfg = cs.family_config(fam)
            traffic = {op: {"bytes": n * cs.PAR_STEPS} for op, n in
                       cs.family_bytes(path, cfg, b, s).items()}
            return [{"pid": 20 + r, "losses": [6.0, 5.5, 5.0],
                     "f32_losses": [6.0, 5.6],
                     "launches": cs.parallel_expected_launches(path),
                     "traffic": traffic,
                     "blocks": cs.family_blocks(path, cfg),
                     **({"ref_losses": [6.0, 5.5, 5.2],
                         "ref_f32_losses": [6.00001, 5.6],
                         "param_errs": [5e-3], "param_move_errs": [0.1],
                         "grad_errs": [2e-4],
                         "f32_route_flip_share": 0.0,
                         "grad_control_errs": {
                             c: 0.9 for c in cs.PAR_FAMILY_CONTROLS[path]}}
                        if r == 0 else {})}
                    for r in range(cs.PAR_RANKS)]

        return {
            **{path: family(path) for path in cs.PAR_FAMILIES},
            "tp": train("tp", {"all_reduce": {"bytes": tp_bytes}}),
            "fsdp": train("fsdp", {op: {"bytes": n}
                                   for op, n in fsdp.items()}),
            "ulysses": [{"launches": cs.parallel_expected_launches(
                "ulysses"), "out_err": 0.0, "grad_errs": [0.0] * 3}] * 2,
            "ring": [{"out_err": 5e-3}] * 2,
            "moe": [{"y_err": 4e-3, "aux": 1.0, "ref_aux": 1.0,
                     "grad_errs": [4e-3] * 4}] * 2,
            "gpipe": pp("gpipe"), "1f1b": pp("1f1b")}

    def test_checks_accept(self):
        checks = cs.parallel_checks(self._rows(), [6.0, 5.5, 5.0], 1)
        assert checks and all(checks.values()), checks

    @pytest.mark.parametrize("path,key,value,failed", [
        ("tp", "launches", {"flash_fwd": 71, "flash_bwd_dq": 36,
                            "flash_bwd_dkv": 36}, "tp_launches"),
        ("fsdp", "pid", 1, "fsdp_other_processes"),
        ("tp", "losses", [6.0, 5.5, 5.2], "tp_losses"),
        ("fsdp", "traffic", {"all_gather": {"bytes": 1},
                             "reduce_scatter": {"bytes": 3000},
                             "all_reduce": {"bytes": 12}}, "fsdp_bytes"),
        ("tp", "traffic", {"all_reduce": {"bytes": 1}}, "tp_bytes"),
        ("ulysses", "grad_errs", [0.0, 0.5, 0.0], "ulysses_grads"),
        ("moe", "aux", 1.1, "moe_aux"),
        ("gpipe", "grad_errs", [0.2], "gpipe_grads"),
        ("1f1b", "launches", {"flash_fwd": 24, "flash_bwd_dq": 24,
                              "flash_bwd_dkv": 24}, "1f1b_launches"),
    ])
    def test_checks_reject(self, path, key, value, failed):
        rows = self._rows()
        rows[path] = [dict(r) for r in rows[path]]
        rows[path][-1][key] = value
        if key == "losses":
            rows[path][0][key] = value
        checks = cs.parallel_checks(rows, [6.0, 5.5, 5.0], 1)
        assert [k for k, ok in checks.items() if not ok] == [failed]

    @pytest.mark.parametrize("kind,key,value,failed", [
        ("tp", "grad_errs", [1e-2, 0.06], "tp_grads"),
        ("fsdp", "grad_errs", [0.2], "fsdp_grads"),
        # a planted fault the band would let through
        ("tp", "grad_control_errs", {"doubled": 1.0,
                                     "wqkv_contiguous_blocks": 1.4,
                                     "f_sums_dropped": 0.04},
         "tp_grad_controls_rejected"),
        # a control that was not read
        ("tp", "grad_control_errs", {"doubled": 1.0},
         "tp_grad_controls_rejected"),
        ("fsdp", "grad_control_errs", {"doubled": 0.01},
         "fsdp_grad_controls_rejected"),
    ])
    def test_grad_band_and_controls_reject(self, kind, key, value, failed):
        rows = self._rows()
        rows[kind][0][key] = value
        checks = cs.parallel_checks(rows, [6.0, 5.5, 5.0], 1)
        assert [k for k, ok in checks.items() if not ok] == [failed]

    @pytest.mark.parametrize("path,key,value,failed", [
        ("llama_tp", "launches", {"flash_fwd": 47, "flash_bwd_dq": 48,
                                  "flash_bwd_dkv": 48}, "llama_tp_launches"),
        ("vit_tp", "f32_losses", [6.0, 5.61], "vit_tp_losses"),
        ("vit_tp", "losses", [6.0, float("nan"), 5.0], "vit_tp_losses"),
        ("moe_tp", "grad_errs", [2e-4, 2e-3], "moe_tp_grads"),
        ("moe_ep", "param_move_errs", [0.3], "moe_ep_params"),
        ("moe_tp", "f32_route_flip_share", 2e-3, "moe_tp_routes"),
        # a planted fault the band would let through, and one not read
        ("moe_tp", "grad_control_errs", {"doubled": 1.0,
                                         "f_sums_dropped": 1.0,
                                         "sum_after_combine": 5e-4},
         "moe_tp_grad_controls_rejected"),
        ("llama_tp", "grad_control_errs", {"doubled": 1.0,
                                           "f_sums_dropped": 1.0},
         "llama_tp_grad_controls_rejected"),
        ("vit_tp", "traffic", {"all_reduce": {"bytes": 1}},
         "vit_tp_bytes"),
        # an op the reckoning does not have (llama's shared-kv gather)
        ("llama_tp", "traffic", "plus_all_gather", "llama_tp_bytes"),
        ("moe_ep", "blocks", {"expert_w1": [8, 512, 1024]},
         "moe_ep_blocks"),
        ("vit_tp", "pid", 1, "vit_tp_other_processes"),
    ])
    def test_family_checks_reject(self, path, key, value, failed):
        rows = self._rows()
        rows[path] = [dict(r) for r in rows[path]]
        if value == "plus_all_gather":
            value = {**rows[path][0]["traffic"],
                     "all_gather": {"bytes": 64}}
        if key in ("losses", "f32_losses"):
            for r in rows[path]:
                r[key] = value
        rows[path][0 if key in ("grad_errs", "param_move_errs",
                                "f32_route_flip_share",
                                "grad_control_errs") else -1][key] = value
        checks = cs.parallel_checks(rows, [6.0, 5.5, 5.0], 1)
        assert [k for k, ok in checks.items() if not ok] == [failed]

    def test_family_launch_expectations(self):
        # Every layer's attention on each rank, 3 steps: llama's
        # tpu_bench without remat (16 layers), ViT-B/16 with (12), the
        # MoE decoder with (4).
        assert cs.parallel_expected_launches("llama_tp") == {
            "flash_fwd": 48, "flash_bwd_dq": 48, "flash_bwd_dkv": 48}
        assert cs.parallel_expected_launches("vit_tp") == {
            "flash_fwd": 72, "flash_bwd_dq": 36, "flash_bwd_dkv": 36}
        for path in ("moe_tp", "moe_ep"):
            assert cs.parallel_expected_launches(path) == {
                "flash_fwd": 24, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}

    def test_family_bytes_at_full_width(self):
        # llama tpu_bench at B=4, S=2048 (no remat): 4 [b, s, d] bf16
        # sums a layer, the embedding's and the final "f", and the
        # loss's f32 max and [2, rows] sums.
        act = 4 * 2048 * 1024 * 2
        assert act == 16_777_216
        assert cs.family_bytes("llama_tp", cs.family_config("llama"), 4,
                               2048) == {"all_reduce": (4 * 16 + 2) * act
                                         + 3 * 4 * 2048 * 4}
        # ViT-B/16 at B=32 (remat, whose recompute sends nothing): 4
        # [b, 197, d] sums a layer and the patch projection's [b, 196, d].
        assert cs.family_bytes("vit_tp", cs.family_config("vit"), 32,
                               None) == {"all_reduce": 48 * 9_682_944
                                         + 32 * 196 * 768 * 2}
        # MoE at B=8, S=1024: capacity 2560, [8, 2560, 512] f32 buffers.
        experts = 8 * 2560 * 512 * 4
        assert cs.family_bytes("moe_ep", cs.family_config("moe"), 8,
                               1024) == {"all_gather": 3 * 4 * experts // 2}

    # The families' tiny configs (the CPU test sizes of the JAX package).
    TINY = {"llama": dict(vocab_size=512, d_model=64, n_heads=4,
                          n_kv_heads=2, n_layers=2, d_ff=96,
                          max_seq_len=128),
            "vit": dict(image_size=32, patch_size=8, d_model=64, n_heads=4,
                        n_layers=2, d_ff=128, num_classes=10),
            "moe": dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2,
                        n_experts=4, d_ff=96, max_seq_len=64)}

    @pytest.mark.parametrize("path", list(cs.PAR_FAMILIES))
    def test_family_path_on_the_cpu(self, pool, path, tmp_path):
        """A family path at a tiny width on 2 CPU ranks: the bytes each
        rank hands each collective in the bf16 steps equal the
        reckoning, the blocks the reckoned shapes, the f32 steps agree
        with the unsplit ones in the f32 bands and every planted fault
        leaves them, and every check but the launches (no kernel runs
        on the CPU) passes."""
        family = cs.PAR_FAMILIES[path][0]
        batch = (4, None) if family == "vit" else (4, 32)
        ref_path = str(tmp_path / "ref.pt")
        cs.par_family_reference(path, ref_path, self.TINY[family], batch,
                                device="cpu")
        import torch_parallel_ranks as ranks

        rows = pool.run(ranks.chip_smoke_call, "par_family_rank", path,
                        ref_path, self.TINY[family], batch, "cpu")
        cfg = cs.family_config(family, **self.TINY[family])
        want = cs.family_bytes(path, cfg, *batch)
        for rank in rows:
            assert {op: r["bytes"] for op, r in rank["traffic"].items()} \
                == {op: n * cs.PAR_STEPS for op, n in want.items()}
        checks = cs.family_checks(path, rows, os.getpid(), cfg, *batch)
        assert [k for k, ok in checks.items() if not ok] == \
            [f"{path}_launches"]
        assert rows[0]["grad_control_errs"].keys() == \
            cs.PAR_FAMILY_CONTROLS[path]

    def test_contiguous_wqkv_order(self):
        # 2 heads of 1 column each for q, k and v; tp=2: rank r holds
        # column r of each, so the blocks side by side read q0 k0 v0 q1
        # k1 v1.
        w = torch.arange(6.0).reshape(1, 6)   # [q0 q1 | k0 k1 | v0 v1]
        assert cs.contiguous_wqkv(w, 2).tolist() == [[0, 2, 4, 1, 3, 5]]
        assert torch.equal(cs.contiguous_wqkv(w, 1), w)
        # llama's wkv: 2 kv heads of 1 column each for k and v
        w = torch.arange(4.0).reshape(1, 4)   # [k0 k1 | v0 v1]
        assert cs.contiguous_wqkv(w, 2, 2).tolist() == [[0, 2, 1, 3]]

    def test_first_grads_optimizer_keeps_the_first_step(self):
        store = []
        p = torch.nn.Parameter(torch.ones(3))
        opt = cs.first_grads_optimizer(store)([p])
        for scale in (2.0, 5.0):
            opt.zero_grad()
            (scale * p).sum().backward()
            opt.step()
        assert len(store) == 1 and store[0].tolist() == [2.0] * 3

    def test_param_band_rejects(self):
        rows = self._rows()
        rows["fsdp"][0]["param_move_errs"] = [0.1, 0.3]
        checks = cs.parallel_checks(rows, [6.0, 5.5, 5.0], 1)
        assert [k for k, ok in checks.items() if not ok] == ["fsdp_params"]


class TestRllibPhase:
    """The rllib phase's environments (the card's host has no gymnasium)
    and its card-vs-CPU gradient band with the planted faults."""

    def test_pixel_env(self):
        import numpy as np

        env = cs.PixelEnv()
        obs, info = env.reset(seed=3)
        assert obs.shape == cs.PIXEL_SHAPE == env.observation_space.shape
        assert obs.dtype == np.float32 and info == {}
        assert 0.0 <= obs.min() and obs.max() <= 1.0
        assert env.action_space.n == cs.PIXEL_ACTIONS
        again, _ = cs.PixelEnv().reset(seed=3)
        np.testing.assert_array_equal(obs, again)
        rewards = []
        for t in range(cs.PIXEL_EPISODE):
            target = env._target
            # the bright patch sits where the rewarded action says
            patch = obs[:, :, 0] == 1.0
            rows, cols = np.nonzero(patch)
            assert patch.sum() == 144
            assert (rows.min() - 8) // 40 * 3 + (cols.min() - 6) // 26 \
                == target
            obs, reward, term, trunc, _ = env.step(target if t % 2 else
                                                   (target + 1) % 6)
            rewards.append(reward)
            assert term == (t == cs.PIXEL_EPISODE - 1) and not trunc
        assert rewards == [0.0, 1.0] * (cs.PIXEL_EPISODE // 2)

    def test_cartpole_follows_gymnasium(self):
        import gymnasium as gym
        import numpy as np

        ours, theirs = cs.CartPoleEnv(), gym.make("CartPole-v1").unwrapped
        obs, _ = ours.reset(seed=5)
        theirs.reset(seed=0)
        theirs.state = obs.astype(np.float64)
        ours._state = obs.astype(np.float64)
        rng = np.random.default_rng(0)
        for t in range(500):
            action = int(rng.integers(2))
            a = ours.step(action)
            b = theirs.step(action)
            np.testing.assert_allclose(a[0], b[0], rtol=1e-6, atol=1e-6)
            assert (a[1], a[2]) == (b[1], b[2])
            if a[2]:
                break
        assert a[2] and t > 5

    def test_cartpole_truncates_at_500(self):
        env = cs.CartPoleEnv()
        env.reset(seed=0)
        env._t = cs.CartPoleEnv.MAX_STEPS - 1
        env._state[:] = 0.0
        _, _, term, trunc, _ = env.step(0)
        assert (term, trunc) == (False, True)

    def test_two_cartpoles(self):
        env = cs.TwoCartPoles()
        obs, _ = env.reset(seed=1)
        assert sorted(obs) == env.possible_agents == ["a0", "a1"]
        assert [cs.policy_of(a) for a in obs] == ["p0", "p1"]
        while True:
            obs, rew, term, trunc, _ = env.step({"a0": 0, "a1": 1})
            assert rew == {"a0": 1.0, "a1": 1.0}
            if term["__all__"]:
                break
            assert not any(term.values())
        assert term["__all__"] == (term["a0"] or term["a1"])

    @pytest.fixture(scope="class")
    def pixel_grads(self):
        import numpy as np

        from ray_tpu_torch.rllib import PPOModule, TorchLearner
        from ray_tpu_torch.rllib.algorithms.ppo import make_ppo_loss

        n = cs.RLLIB_MINIBATCH
        env = cs.PixelEnv()
        frames = [env.reset(seed=0)[0]] + [env.step(0)[0]
                                           for _ in range(n + 1)]
        rng = np.random.default_rng(0)
        frag = {"obs": np.stack(frames), "actions": rng.integers(0, 6, n + 2),
                "action_logp": np.full(n + 2, -1.8, np.float32),
                "rewards": rng.random(n + 2).astype(np.float32),
                "vf_preds": rng.random(n + 2).astype(np.float32),
                "terminateds": np.zeros(n + 2, bool),
                "truncateds": np.zeros(n + 2, bool)}
        batch = cs.rllib_minibatch([frag], 0.99, n)
        assert {k: v.shape[0] for k, v in batch.items()} == dict.fromkeys(
            ("obs", "actions", "action_logp", "advantages",
             "value_targets"), n)

        def grads(fault=None, seed=0, dtype=torch.float32):
            """The PPO loss's gradients on ``batch`` at the weights drawn
            from ``seed``, in ``dtype``, with a planted ``fault``."""
            from ray_tpu_torch._tree import tree_leaves, tree_unflatten
            from ray_tpu_torch.rllib.core.rl_module import apply_net

            module = PPOModule(cs.PIXEL_SHAPE, 6)
            if fault:
                cs.plant_fault(module, fault)
            params = module.init_params(seed)  # drawn in f32, then cast
            net = module.net.to(dtype)
            params = tree_unflatten(params, [
                t.to(dtype).requires_grad_() for t in tree_leaves(params)])
            host = {k: torch.as_tensor(v) for k, v in batch.items()}
            host = {k: v.to(dtype) if v.is_floating_point() else v
                    for k, v in host.items()}
            shim = type("Shim", (), {"apply": staticmethod(
                lambda p, obs: apply_net(net, p, obs))})
            loss, _ = make_ppo_loss()(params, shim, host)
            return tree_unflatten(params, torch.autograd.grad(
                loss, tree_leaves(params)))

        return grads

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_gradient_band_admits_f32_rounding(self, pixel_grads, seed):
        # f32 against f64 on the CPU: rounding alone, relu flips
        # included, stays inside the band that holds the card to the CPU
        # (seed 0 reads 7.2e-3, the others 2.6e-4 or less).
        errs = cs.grad_errs(pixel_grads(seed=seed),
                            pixel_grads(seed=seed, dtype=torch.float64))
        assert len(errs) == 16 and max(errs.values()) <= cs.TOL_RLLIB_GRADS

    @pytest.mark.parametrize("fault", ["nchw_flatten", "pads_before"])
    def test_gradient_band_rejects_planted_faults(self, pixel_grads, fault):
        errs = cs.grad_errs(pixel_grads(fault), pixel_grads())
        assert max(errs.values()) > 10 * cs.TOL_RLLIB_GRADS

    def test_finite_losses(self):
        assert cs.finite_losses({"total_loss": 1.0, "epsilon": float("nan")})
        assert not cs.finite_losses({"vf_loss": float("inf")})
        assert not cs.finite_losses({"epsilon": 0.5})


def _cast(tree, dtype):
    from ray_tpu_torch._tree import tree_map

    return tree_map(lambda t, _: t.to(dtype) if torch.is_tensor(t)
                    and t.is_floating_point() else t, tree)


def _pendulum_batch(seed: int, n: int = 256):
    """``n`` transitions of PendulumEnv under uniform actions."""
    import numpy as np

    env, rng = cs.PendulumEnv(), np.random.default_rng(seed)
    obs, _ = env.reset(seed=seed)
    cols = {k: [] for k in ("obs", "actions", "rewards", "terminateds",
                            "next_obs")}
    for _ in range(n):
        action = rng.uniform(-1, 1, 1).astype(np.float32)
        nxt, reward, term, trunc, _ = env.step(2 * action)
        for k, v in zip(cols, (obs, action, reward, term, nxt)):
            cols[k].append(v)
        obs = env.reset()[0] if trunc else nxt
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in cols.items()}
    return {k: v.float() if v.is_floating_point() else v
            for k, v in batch.items()}


class TestOffPolicyPhase:
    """The rllib_offpolicy phase's Pendulum (the card's host has no
    gymnasium) and its card-vs-CPU measures with the planted faults."""

    def test_pendulum_follows_gymnasium(self):
        import gymnasium as gym
        import numpy as np

        ours, theirs = cs.PendulumEnv(), gym.make("Pendulum-v1")
        rng = np.random.default_rng(0)
        a, b = ours.reset(seed=7)[0], theirs.reset(seed=7)[0]
        resets = 0
        for _ in range(450):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
            # past the torque limit too: both clip it
            action = rng.uniform(-2.5, 2.5, 1).astype(np.float32)
            a, ra, ta, ua, _ = ours.step(action)
            b, rb, tb, ub, _ = theirs.step(action)
            assert abs(float(ra) - float(rb)) <= 1e-6 * max(1.0, abs(rb))
            assert (ta, ua) == (tb, ub)
            if ua:
                a, b = ours.reset()[0], theirs.reset()[0]
                resets += 1
        assert resets == 2
        theirs.close()

    def test_pendulum_spaces(self):
        import numpy as np

        from ray_tpu_torch.rllib.env.env_runner import unsquash_action

        env = cs.PendulumEnv()
        assert env.observation_space.shape == (3,)
        assert env.action_space.shape == (1,)
        np.testing.assert_array_equal(
            unsquash_action(np.array([-1.0, 0.0, 1.0], np.float32),
                            env.action_space), [-2.0, 0.0, 2.0])

    @pytest.mark.parametrize("shape", [cs.FRAMES_SHAPE, (16, 16, 1)])
    def test_frames_env(self, shape):
        import numpy as np

        config = None if shape == cs.FRAMES_SHAPE else {"shape": shape}
        env = cs.FramesEnv(config)
        obs, _ = env.reset(seed=3)
        assert obs.shape == shape == env.observation_space.shape
        assert obs.dtype == np.float32 and 0 <= obs.min() <= obs.max() <= 1
        assert env.action_space.n == cs.FRAMES_ACTIONS == 6
        np.testing.assert_array_equal(obs, cs.FramesEnv(config).reset(
            seed=3)[0])
        lit = np.argwhere(obs[..., 0] == 1.0)
        assert len(lit) == 64 and tuple(lit.min(0) // 8) == env._agent
        total = 0.0
        for t in range(cs.FRAMES_EPISODE):
            before = env._agent
            # walk toward the goal, one axis at a time
            (dr, dc) = np.sign(np.subtract(env._goal, env._agent))
            action = (0 if dr < 0 else 1) if dr else \
                (2 if dc < 0 else 3) if dc else 4
            obs, reward, term, trunc, _ = env.step(action)
            total += reward
            assert abs(env._agent[0] - before[0]) + abs(
                env._agent[1] - before[1]) <= 1
            assert not term and trunc == (t == cs.FRAMES_EPISODE - 1)
        assert total >= 5

    def test_errs_over_dicts_and_lists(self):
        tree = {"a": [{"w": torch.ones(2)}, {"w": torch.full((2,), 2.0)}],
                "b": torch.tensor([4.0, -4.0])}
        other = {"a": [{"w": torch.ones(2)}, {"w": torch.tensor([2.0,
                                                                 3.0])}],
                 "b": torch.tensor([4.0, -4.0])}
        assert cs.grad_errs(other, tree) == {"a.0.w": 0.0, "a.1.w": 0.5,
                                             "b": 0.0}
        assert cs.tree_err(other, tree) == 0.25

    def test_step_errs_skip_unclear_first_gradients(self):
        ref = {"w": torch.zeros(3)}
        grads = {"w": torch.tensor([1.0, 1e-6, 0.5])}
        moved = {"w": torch.tensor([0.0, 2e-3, 1e-4])}
        # the second element's first step may take either sign: skipped
        assert cs.step_errs(moved, ref, grads, 1e-3) == {
            "w": pytest.approx(0.1)}
        with pytest.raises(ValueError):
            cs.plant_rl_fault(None, "no_such_fault")

    @pytest.fixture(scope="class")
    def offpolicy(self):
        from ray_tpu_torch.rllib.algorithms.cql import make_cql_penalty
        from ray_tpu_torch.rllib.algorithms.sac import make_sac_update
        from ray_tpu_torch.rllib.algorithms.td3 import (TD3Module,
                                                         make_td3_update)
        from ray_tpu_torch.rllib.core.learner import gradients
        from ray_tpu_torch.rllib.core.rl_module import SACModule

        def measure(name, seed, dtype, fault=None):
            """What the phase holds card vs CPU, here at ``dtype`` from
            the weights drawn from ``seed``: SAC's and CQL's gradients
            (CQL's penalty's too), TD3's params after two steps."""
            if name == "td3":
                update = make_td3_update(TD3Module(3, 1), 0.99, 1e-3, 0.005,
                                         2, 0.2, 0.5, device="cpu")
            else:
                module = SACModule(3, 1)
                update = make_sac_update(
                    module, 0.99, 3e-4, 0.005, -1.0, device="cpu",
                    critic_penalty_fn=make_cql_penalty(module, 1.0, 8)
                    if name == "cql" else None)
            if fault:
                cs.plant_rl_fault(update, fault)
            weights = update.module.init_params(seed)
            batch = _cast(_pendulum_batch(seed), dtype)
            noise = _cast(update.noise(256, torch.Generator().manual_seed(
                seed)), dtype)
            state = update.init_state(params=_cast(weights, dtype))
            p = state["params"]
            if name == "td3":
                first = {"q": gradients(update.critic_loss(
                    p["q"], state["target"], batch, noise), p["q"]),
                    "actor": gradients(update.actor_loss(
                        p["actor"], p["q"], batch), p["actor"])}
                for _ in range(2):
                    update(state, batch, noise)
                return state["params"], first
            out = {"update": update.gradients(state, batch, noise)[1]}
            if name == "cql":
                q1, q2 = update.module.apply_q(p, batch["obs"],
                                               batch["actions"])
                out["penalty"] = gradients(update.critic_penalty(
                    p, batch, q1, q2, noise)[0], p["q"])
            return out

        def errs(ours, ref):
            if isinstance(ours, tuple):  # TD3: in Adam steps
                return max(cs.step_errs(ours[0], ref[0], ref[1],
                                        1e-3).values())
            out = max(cs.grad_errs(ours["update"], ref["update"]).values())
            if "penalty" in ours:
                out = max(out, cs.tree_err(ours["penalty"], ref["penalty"]))
            return out

        return measure, errs

    @pytest.mark.parametrize("name", ["sac", "cql", "td3"])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_band_admits_f32_rounding(self, offpolicy, name, seed):
        # f32 against f64 on the CPU (saturated tanh actions included:
        # seed 1 reads 3.4e-3 for SAC and CQL, TD3 2.4e-3 steps at most)
        measure, errs = offpolicy
        tol = cs.TOL_TD3_STEPS if name == "td3" else cs.TOL_OFFPOLICY_GRADS
        assert errs(measure(name, seed, torch.float32),
                    measure(name, seed, torch.float64)) <= tol

    @pytest.mark.parametrize("name,fault", [
        ("sac", "actor_q_no_grad"), ("cql", "repeat_tiles"),
        ("td3", "actor_every_step")])
    def test_band_rejects_planted_faults(self, offpolicy, name, fault):
        measure, errs = offpolicy
        tol = cs.TOL_TD3_STEPS if name == "td3" else cs.TOL_OFFPOLICY_GRADS
        for seed in (0, 1):
            assert errs(measure(name, seed, torch.float32, fault),
                        measure(name, seed, torch.float64)) > 5 * tol


class TestDreamerPhase:
    """The dreamer phase's card-vs-CPU band, its flip count and its
    planted faults, at a small width (16x16x3 frames) on the CPU."""

    @pytest.fixture(scope="class")
    def dreamer(self):
        import numpy as np

        from ray_tpu_torch.rllib.algorithms.dreamerv3 import (
            DreamerModule, make_dreamer_update)

        env, rng = cs.FramesEnv({"shape": (16, 16, 3)}), \
            np.random.default_rng(0)
        b, t = 4, 8
        frames = [env.reset(seed=0)[0]]
        actions = rng.integers(0, 6, b * t)
        rewards, terms = [], []
        for a in actions[:-1]:
            obs, reward, term, _, _ = env.step(a)
            frames.append(obs)
            rewards.append(reward)
            terms.append(term)
        batch = {"obs": torch.as_tensor(np.stack(frames)).reshape(
            b, t, 16, 16, 3),
            "actions": torch.as_tensor(actions).reshape(b, t),
            "rewards": torch.as_tensor(rewards + [0.0]).float().reshape(
                b, t),
            "terminateds": torch.as_tensor(terms + [False]).reshape(b, t),
            "is_first": torch.arange(t).expand(b, t) == 0}

        def update(fault=None):
            module = DreamerModule((16, 16, 3), 6, n_deter=32, n_cat=4,
                                   n_classes=4, hidden=32, cnn_depth=8,
                                   n_bins=41)
            out = make_dreamer_update(module, horizon=5, device="cpu")
            return cs.plant_rl_fault(out, fault) if fault else out

        weights = update().module.init_params(0)
        noise = update().noise(b, t, torch.Generator().manual_seed(0))

        def grads(dtype, fault=None):
            u = update(fault)
            state = u.init_state(params=_cast(weights, dtype))
            return u.gradients(state, _cast(batch, dtype),
                               _cast(noise, dtype))[1]

        return update, weights, batch, noise, grads

    def test_band_admits_f32_rounding(self, dreamer):
        update, weights, batch, noise, grads = dreamer
        ours, ref = grads(torch.float32), grads(torch.float64)
        errs = {k: max(cs.grad_errs(ours[k], ref[k]).values())
                for k in ("wm", "actor", "critic")}
        assert max(errs.values()) <= cs.TOL_DREAMER_GRADS / 100, errs
        flips = cs.categorical_flips(
            update(), update(), _cast(weights, torch.float64),
            _cast(batch, torch.float64), _cast(noise, torch.float64))
        assert {k: v["flips"] for k, v in flips.items()} == dict.fromkeys(
            ("posterior_latents", "imagined_actions", "imagined_latents"),
            0)
        assert flips["posterior_latents"]["of"] == 4 * 8 * 4

    @pytest.mark.parametrize("fault", ["deconv_unflipped",
                                       "no_straight_through",
                                       "bin_one_high"])
    def test_band_rejects_planted_faults(self, dreamer, fault):
        *_, grads = dreamer
        ours, ref = grads(torch.float32, fault), grads(torch.float64)
        assert max(max(cs.grad_errs(ours[k], ref[k]).values())
                   for k in ours) > 100 * cs.TOL_DREAMER_GRADS


def _report(base: dict, path: str, value):
    """A deep copy of ``base`` with the key at the dotted ``path`` set."""
    import copy

    out = copy.deepcopy(base)
    node = out
    *parents, last = path.split(".")
    for key in parents:
        node = node[key]
    node[last] = value
    return out


class TestMultihostHelpers:
    """What the multinode and autoscale phases read of a daemon after it
    is gone (``_private/test_utils.py``): the live members of its process
    group and the directories it stamped with its pid."""

    def test_group_members_count_live_processes_only(self):
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import subprocess, sys, time; "
             "subprocess.Popen([sys.executable, '-c', "
             "'import time; time.sleep(60)']); time.sleep(60)"],
            start_new_session=True)
        try:
            deadline = time.monotonic() + 30
            while len(tu.group_members(proc.pid)) < 2:
                assert time.monotonic() < deadline
                time.sleep(0.02)
            members = tu.group_members(proc.pid)
            assert proc.pid in members and len(members) == 2
            assert tu.proc_stat(proc.pid)[2] == str(proc.pid)
        finally:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
        deadline = time.monotonic() + 30
        while tu.group_members(proc.pid):  # the orphan is reaped by init
            assert time.monotonic() < deadline, tu.group_members(proc.pid)
            time.sleep(0.02)
        assert tu.proc_stat(proc.pid) == []

    def test_owned_dirs_read_the_owner_stamp(self, tmp_path):
        from ray_tpu_torch._private.config import shm_prefix, temp_root

        mine = [os.path.join("/dev/shm", shm_prefix() + "node_test_" +
                             str(os.getpid())),
                os.path.join(temp_root(), "rtt_sessions",
                             f"node_test_{os.getpid()}")]
        other = os.path.join(temp_root(), "rtt_sessions",
                             f"node_other_{os.getpid()}")
        try:
            for d, pid in ((mine[0], 4242424), (mine[1], 4242424),
                           (other, 4242425)):
                os.makedirs(d)
                with open(os.path.join(d, ".owner_pid"), "w") as f:
                    f.write(str(pid))
            assert tu.owned_dirs(4242424) == sorted(mine)
            assert tu.owned_dirs(4242425) == [other]
            assert tu.owned_dirs(4242426) == []
        finally:
            for d in (*mine, other):
                shutil.rmtree(d, ignore_errors=True)


class TestMultinodePhase:
    REPORT = {
        "n_layers": 12, "daemon_node": "d" * 32, "daemon_pid": 200,
        "driver_pid": 100, "cluster_gpus": 1.0,
        "gpus_by_node": {"head": 0.0, "daemon": 1.0},
        "pool_actor": {"pid": 300, "node": "d" * 32, "pgid": 200,
                       "flash_fwd": 96, "flash_bwd_dq": 0,
                       "flash_bwd_dkv": 0},
        "driver_launches": {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0},
        "rows": 16, "equal_rows": 16,
        "tensor": {"node": "d" * 32, "device": "cpu",
                   "dtype": "torch.bfloat16", "equal": True,
                   "cuda_visible_devices": "0"},
        "dirs_during": 2, "left_processes": [], "left_dirs": [],
        "card_free_before": 80 << 30, "card_free_after": (80 << 30) - 1}

    def test_report_accepted(self):
        assert all(cs.multinode_checks(self.REPORT).values())

    @pytest.mark.parametrize("path,value,failed", [
        ("cluster_gpus", 2.0, "gpu_once"),                 # counted twice
        ("gpus_by_node.head", 1.0, "gpu_once"),
        ("driver_pid", 200, "daemon_process"),
        ("pool_actor.node", "h" * 32, "stage_on_daemon"),  # on the head
        ("pool_actor.pgid", 100, "stage_on_daemon"),       # not its group
        ("pool_actor.pid", 100, "stage_on_daemon"),        # the driver
        ("pool_actor.flash_fwd", 0, "launches"),           # the plain path
        ("pool_actor.flash_bwd_dq", 12, "launches"),
        ("driver_launches.flash_fwd", 96, "driver_launches"),
        ("equal_rows", 15, "tokens_equal"),
        ("tensor.device", "cuda:0", "tensor"),
        ("tensor.equal", False, "tensor"),
        ("tensor.node", "h" * 32, "tensor"),
        ("tensor.cuda_visible_devices", "", "tensor"),
        ("left_processes", [301], "daemon_reaped"),
        ("left_dirs", ["/dev/shm/rtt_x_node_1"], "dirs_removed"),
        ("dirs_during", 0, "dirs_removed"),
        ("card_free_after", (80 << 30) - (600 << 20), "memory_back"),
        ("card_free_after", None, "memory_back"),
    ])
    def test_report_rejected(self, path, value, failed):
        checks = cs.multinode_checks(_report(self.REPORT, path, value))
        assert [k for k, ok in checks.items() if not ok] == [failed]

    def test_phase_on_the_cpu(self, capsys):
        """The whole phase at a tiny width on the CPU, the daemon's GPU
        faked: every check but K1's launches (the plain path here) and
        the card's memory passes."""
        import json

        from ray_tpu_torch.models import GPTConfig

        with pytest.raises(AssertionError) as err:
            cs.phase_multinode(GPTConfig.tiny(), "cpu")
        assert "['launches', 'memory_back']" in str(err.value)
        (line,) = [x for x in capsys.readouterr().out.splitlines()
                   if x.startswith('{"phase": "multinode"')]
        m = json.loads(line)
        assert m["pool_actor"]["pgid"] == m["daemon_pid"]
        assert m["weights_bytes"] > 0 and m["weights_pull_s"] > 0
        assert m["rows"] == m["equal_rows"] == 16


class TestAutoscalePhase:
    REPORT = {
        "daemon_node": "d" * 32, "daemon_pid": 200, "daemon_gpus": 1.0,
        "launched": 1,
        "task": {"node": "d" * 32, "cuda_visible_devices": "0", "pgid": 200,
                 "launches": {"flash_fwd": 1, "flash_bwd_dq": 0,
                              "flash_bwd_dkv": 0},
                 "finite": True, "max_norm_err": 4e-3},
        "final_statuses": {"TERMINATED": 1}, "gpus_after": None,
        "daemon_exit": 0, "left_processes": []}

    def test_report_accepted(self):
        assert all(cs.autoscale_checks(self.REPORT).values())

    @pytest.mark.parametrize("path,value,failed", [
        ("launched", 2, "one_daemon"),
        ("daemon_gpus", None, "one_daemon"),
        ("task.node", "h" * 32, "task_on_daemon"),
        ("task.pgid", 100, "task_on_daemon"),
        ("task.cuda_visible_devices", "", "task_on_daemon"),
        ("task.launches.flash_fwd", 0, "k1_launched"),
        ("task.max_norm_err", 3e-2, "k1_in_band"),
        ("task.finite", False, "k1_in_band"),
        ("final_statuses", {"RAY_RUNNING": 1}, "scaled_down"),
        ("gpus_after", 1.0, "scaled_down"),
        ("daemon_exit", None, "daemon_exited"),
        ("left_processes", [300], "daemon_exited"),
    ])
    def test_report_rejected(self, path, value, failed):
        checks = cs.autoscale_checks(_report(self.REPORT, path, value))
        assert [k for k, ok in checks.items() if not ok] == [failed]

    def test_phase_on_the_cpu(self, capsys):
        """The whole phase on the CPU at a small shape, the daemon's GPU
        faked: every check but K1's launch passes."""
        with pytest.raises(AssertionError) as err:
            cs.phase_autoscale((1, 2, 64, 16), "cpu")
        assert "['k1_launched']" in str(err.value)
        assert '"final_statuses": {"TERMINATED": 1}' in \
            capsys.readouterr().out



def _cli_client_report():
    """A cli_client report as the card should give it."""
    call = {"launches": {"flash_fwd": 96, "flash_bwd_dq": 0,
                         "flash_bwd_dkv": 0},
            "pid": 253, "pgid": 228, "node": "n" * 32,
            "cuda_visible_devices": "0", "rows": 16, "equal_rows": 16}
    row = {"max_norm_err": 3.4e-3, "finite": True, "pid": 289,
           "cuda_visible_devices": "0",
           "launches": {"flash_fwd": 1, "flash_bwd_dq": 0,
                        "flash_bwd_dkv": 0}}
    return {
        "n_layers": 12, "driver_pid": 120, "head_pid": 211, "node_pid": 228,
        "node_id": "n" * 32, "status_rc": 0, "list_rc": 0,
        "status": {"resources": {"CPU": [10.0, 10.0], "GPU": [1.0, 1.0]},
                   "nodes": 2},
        "listed_alive": 2, "gpus_by_node": {"head": 0.0, "node": 1.0},
        "stage_calls": [call, dict(call)],
        "driver_sum": 4434.0146484375,
        "tensor": {"arrived_on": "cpu", "dtype": "torch.bfloat16",
                   "sum": 4434.0146484375, "node": "n" * 32,
                   "cuda_visible_devices": "0"},
        "head_group": [211, 225, 226], "head_cuda_files": {},
        "worker_cuda_files": {"fds": ["/dev/nvidia-uvm", "/dev/nvidia6"],
                              "maps": ["/dev/nvidia-uvm", "/dev/nvidia6"]},
        "pool": {"rows": [dict(row) for _ in range(cs.POOL_INPUTS)],
                 "launches": {"flash_fwd": 4, "flash_bwd_dq": 0,
                              "flash_bwd_dkv": 0},
                 "pids": [289]},
        "head_exit": 0, "node_exit": 0,
        "dirs_during": {"head": 2, "node": 2},
        "left_processes": [], "left_dirs": [],
        "card_free_before": 80 << 30, "card_free_after": (80 << 30) - 1}


class TestCliClientPhase:
    def test_report_accepted(self):
        assert all(cs.cli_client_checks(_cli_client_report()).values())

    @pytest.mark.parametrize("path,value,failed", [
        ("status.resources.GPU", [1.0, 2.0], "cli_status"),  # counted twice
        ("status.nodes", 1, "cli_status"),
        ("listed_alive", 1, "cli_status"),
        ("gpus_by_node.head", 1.0, "cli_status"),  # the head took the card
        ("status_rc", 1, "cli_status"),
        ("stage_calls.0.node", "h" * 32, "stage_on_node"),
        ("stage_calls.1.pgid", 211, "stage_on_node"),   # the head's group
        ("stage_calls.0.pid", 225, "stage_on_node"),    # a head process
        ("stage_calls.0.cuda_visible_devices", "", "stage_on_node"),
        ("stage_calls.1.cuda_visible_devices", "0,1", "stage_on_node"),
        ("stage_calls.1.launches.flash_fwd", 0, "launches"),  # plain path
        ("stage_calls.0.launches.flash_bwd_dq", 12, "launches"),
        ("stage_calls.1.equal_rows", 15, "tokens_equal"),
        ("tensor.arrived_on", "cuda:0", "tensor"),
        ("tensor.sum", 4434.0, "tensor"),
        ("tensor.dtype", "torch.float32", "tensor"),
        ("head_cuda_files", {"211": {"fds": ["/dev/nvidiactl"],
                                     "maps": []}}, "head_no_context"),
        ("worker_cuda_files.maps", [], "head_no_context"),  # blind probe
        ("pool.rows.2.max_norm_err", 3e-2, "pool_in_band"),
        ("pool.rows.0.finite", False, "pool_in_band"),
        ("pool.launches.flash_fwd", 0, "pool_launches"),
        ("pool.pids", [120], "pool_launches"),            # the driver
        ("pool.pids", [289, 290], "pool_launches"),
        ("pool.rows.1.cuda_visible_devices", "", "pool_launches"),
        ("head_exit", None, "teardown"),
        ("node_exit", -15, "teardown"),
        ("left_processes", [253], "teardown"),
        ("left_dirs", ["/dev/shm/rtt_x_node_1"], "teardown"),
        ("dirs_during.node", 0, "teardown"),
        ("card_free_after", (80 << 30) - (600 << 20), "memory_back"),
        ("card_free_after", None, "memory_back"),
    ])
    def test_report_rejected(self, path, value, failed):
        m = _cli_client_report()
        node = m
        *parents, last = path.split(".")
        for key in parents:
            node = node[int(key)] if isinstance(node, list) else node[key]
        if isinstance(node, list):
            node[int(last)] = value
        else:
            node[last] = value
        checks = cs.cli_client_checks(m)
        assert [k for k, ok in checks.items() if not ok] == [failed]

    def test_head_banner_and_status_parse(self):
        lines = [
            "ray_tpu_torch head started.",
            "  client address:  127.0.0.1:10001  (--address for other "
            "commands)",
            "  cluster address: 127.0.0.1:40123  (python -m ray_tpu_torch "
            "start --address ... on worker hosts)",
            "  cluster token:   " + "ab" * 16 + "  (--token-hex on worker "
            "hosts)",
            "  dashboard:       http://127.0.0.1:8265",
            '  resources:       {"CPU": 2.0}']
        assert cs.parse_head_banner(lines[:3]) == {
            "client": "127.0.0.1:10001", "cluster": "127.0.0.1:40123"}
        assert cs.parse_head_banner(lines) == {
            "client": "127.0.0.1:10001", "cluster": "127.0.0.1:40123",
            "token": "ab" * 16, "dashboard": "http://127.0.0.1:8265"}
        status = ("======== Cluster status ========\n"
                  "  CPU: 3/4 available\n  GPU: 0/1 available\n"
                  "  memory: 1.35217e+11/1.35217e+11 available\n"
                  "  nodes: 2\n")
        assert cs.parse_status(status) == {
            "resources": {"CPU": [3.0, 4.0], "GPU": [0.0, 1.0],
                          "memory": [1.35217e11, 1.35217e11]}, "nodes": 2}

    def test_head_banner_is_what_the_cli_prints(self):
        """The labels parse_head_banner reads are the ones cmd_start
        prints."""
        src = open(os.path.join(REPO, "ray_tpu_torch", "scripts",
                                "cli.py")).read()
        for label in ("client address:", "cluster address:",
                      "cluster token:", "dashboard:"):
            assert f'"  {label}' in src or f'f"  {label}' in src, label

    def test_cuda_files_of_a_process_without_a_card(self):
        assert cs.cuda_files(os.getpid()) == {"fds": [], "maps": []}
        assert cs.cuda_files(2 ** 22 + 12345) == {"fds": [], "maps": []}

    def test_phase_on_the_cpu(self, capsys):
        """The whole phase at a tiny width on the CPU, the node's GPU
        faked: every check but those that need the card passes (K1's
        launches, on the plain path here; the stage's worker maps no
        card, so the head's check has no control; the card's memory)."""
        import json

        from ray_tpu_torch.models import GPTConfig

        with pytest.raises(AssertionError) as err:
            cs.phase_cli_client(GPTConfig.tiny(), "cpu", (1, 2, 64, 16))
        assert "['launches', 'head_no_context', 'pool_launches', " \
            "'memory_back']" in str(err.value)
        (line,) = [x for x in capsys.readouterr().out.splitlines()
                   if x.startswith('{"phase": "cli_client"')]
        m = json.loads(line)
        assert m["head_cuda_files"] == {} and m["tensor"]["sum"] == \
            m["driver_sum"]
        assert [c["equal_rows"] for c in m["stage_calls"]] == [16, 16]
        assert m["left_processes"] == [] and m["left_dirs"] == []

def _libraries_report():
    """A libraries report as the card should give it: the first trial's
    steps 1-4 in one process and 5-8 in its retry, the lr 2e-4 trial cut
    after 3 steps, the lr 0 one after 4."""
    ref = [10.9 - 0.3 * i for i in range(cs.TUNE_STEPS)]
    rows = []
    for lr, pid, steps in ((6e-4, 301, range(1, 5)), (6e-4, 302, range(5, 9)),
                           (2e-4, 303, range(1, 4)), (0.0, 304, range(1, 5))):
        for step in steps:
            row = {"lr": lr, "step": step, "pid": pid,
                   "loss": ref[step - 1] if lr == 6e-4 else 10.9,
                   "step_s": 0.13, "cuda_visible_devices": "0",
                   "gpu_ids": [0], "device_count": 1,
                   "launches": {"flash_fwd": 24, "flash_bwd_dq": 12,
                                "flash_bwd_dkv": 12}}
            if step == steps[0]:
                row.update(cold_start_s=8.0, init_s=6.0,
                           process_age_at_entry_s=1.0,
                           dashboard={"gpu_total": 1.0,
                                      "gpu_available": 0.0, "nodes": 1})
            if pid == 302:
                row.update(restore_s=1.0, restored_from="checkpoint_000004",
                           restored_digest="d4")
            if step == 4:
                row.update(checkpoint_write_s=1.5, checkpoint_bytes=741 << 20,
                           saved_digest="d4")
            rows.append(row)
    k1 = {"launches": {"flash_fwd": 1, "flash_bwd_dq": 0,
                       "flash_bwd_dkv": 0},
          "finite": True, "cuda_visible_devices": "0", "max_norm_err": 4e-3}
    return {
        "n_layers": 12, "rows": rows, "errors": [],
        "iterations": {6e-4: 8, 2e-4: 3, 0.0: 4}, "best_lr": 6e-4,
        "trial_processes": 4, "reference_losses": ref,
        "train_first_loss": ref[0],
        "dashboard_after": {"gpu_total": 1.0, "gpu_available": 1.0,
                            "nodes": 1},
        "metrics_samples": 20, "metrics_malformed": [],
        "card_free_before": 80 << 30, "card_free_after": (80 << 30) - 1,
        "workflow_shape": [16, 12, 1024, 64],
        "workflow": {
            "statuses": ["FAILED", "SUCCESSFUL"], "step1_runs": [1, 1, 2],
            "step1_reports": [k1, dict(k1)],
            "resume_launches": {"flash_fwd": 0, "flash_bwd_dq": 0,
                                "flash_bwd_dkv": 0},
            "equal_to_uninterrupted": True,
            "output": {"device": "cpu", "dtype": "torch.bfloat16",
                       "shape": [16, 12, 1024, 64], "finite": True}},
        "job": {"status": "SUCCEEDED", "return_code": 0,
                "entrypoint_cuda_available": "False", "stop": True,
                "stopped_status": "STOPPED"}}


def _set_row(key, value, pid=None, step=None):
    def change(m):
        for row in m["rows"]:
            if (pid is None or row["pid"] == pid) and \
                    (step is None or row["step"] == step):
                row[key] = value
                return
    return change


def _drop_restored(m):
    for row in m["rows"]:
        row.pop("restored_from", None)


class TestLibrariesPhase:
    def test_report_accepted(self):
        assert all(cs.libraries_checks(_libraries_report()).values())

    @pytest.mark.parametrize("change,failed", [
        (_set_row("cuda_visible_devices", ""), "pinned"),
        (_set_row("device_count", 2, pid=303), "pinned"),
        (_set_row("gpu_ids", [], pid=304), "pinned"),
        (lambda m: m["iterations"].update({0.0: 8}), "asha_cut"),
        (lambda m: m.update(best_lr=0.0), "asha_cut"),
        (lambda m: m["iterations"].update({6e-4: 6}), "asha_cut"),
        (_set_row("loss", 11.2, pid=301, step=1), "first_loss"),
        (_set_row("loss", 9.0, pid=302, step=6), "resumed"),
        (_drop_restored, "resumed"),
        (_set_row("restored_digest", "d5", pid=302), "resumed"),
        (_set_row("saved_digest", None, pid=301, step=4), "resumed"),
        (_set_row("pid", 301, pid=302, step=5), "resumed"),  # no retry
        (_set_row("launches", {"flash_fwd": 12, "flash_bwd_dq": 12,
                               "flash_bwd_dkv": 12}, pid=303), "launches"),
        (_set_row("dashboard", {"gpu_total": 1.0, "gpu_available": 1.0,
                                "nodes": 1}, pid=304), "dashboard_during"),
        (lambda m: m.update(trial_processes=5), "dashboard_during"),
        (lambda m: m["dashboard_after"].update(gpu_available=0.0),
         "dashboard_after"),
        (lambda m: m.update(metrics_malformed=["up {x} 1 2"]),
         "metrics_text"),
        (lambda m: m.update(card_free_after=(80 << 30) - (600 << 20)),
         "memory_back"),
        (lambda m: m.update(card_free_after=None), "memory_back"),
        (lambda m: m["workflow"].update(step1_runs=[1, 2, 3]),
         "workflow_resume"),
        (lambda m: m["workflow"]["resume_launches"].update(flash_fwd=1),
         "workflow_resume"),
        (lambda m: m["workflow"].update(equal_to_uninterrupted=False),
         "workflow_resume"),
        (lambda m: m["workflow"]["output"].update(device="cuda:0"),
         "workflow_resume"),
        (lambda m: m["workflow"].update(statuses=["FAILED", "FAILED"]),
         "workflow_resume"),
        (lambda m: m["workflow"]["step1_reports"][0]["launches"].update(
            flash_fwd=0), "workflow_k1"),
        (lambda m: m["workflow"]["step1_reports"][1].update(
            max_norm_err=3e-2), "workflow_k1"),
        (lambda m: m["job"].update(stopped_status="SUCCEEDED"), "job"),
        (lambda m: m["job"].update(entrypoint_cuda_available=None), "job"),
        (lambda m: m.update(errors=["RuntimeError('boom')"]), "no_errors"),
    ])
    def test_report_rejected(self, change, failed):
        m = _libraries_report()
        change(m)
        checks = cs.libraries_checks(m)
        assert [k for k, ok in checks.items() if not ok] == [failed]

    @pytest.mark.parametrize("restore,losses,accepted", [
        ("whole", "run", True),
        ("moments_dropped", "run", False),
        # a restore whose losses happen to stay inside the band
        ("moments_dropped", "reference", False),
    ])
    def test_restore_is_held_to_the_saved_state(self, monkeypatch, tmp_path,
                                                restore, losses, accepted):
        """The trial's own restore at a tiny width on the CPU: a restore
        that loads the params but leaves AdamW's moments and step counts
        behind fails ``resumed``, by the state's digest."""
        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models import GPTConfig, make_train_step

        cfg, lr = GPTConfig.tiny(), cs.TUNE_LRS[0]
        ref = cs.uninterrupted_losses(cfg, "cpu", (2, 64), lr,
                                      cs.TUNE_STEPS)
        init_state, train_step = make_train_step(
            cfg, optimizer=cs.tune_optimizer(lr), device="cpu")
        tokens = cs.token_batch(cfg.vocab_size, 2, 64, device="cpu")
        state = init_state(torch.Generator().manual_seed(0))
        run = []
        for _ in range(cs.TUNE_CHECKPOINT_AT):
            state, m = train_step(state, tokens)
            run.append(float(m["loss"]))
        saved_digest = cs.train_state_digest(state)
        checkpoint = train.Checkpoint.from_state(state, str(tmp_path))
        if restore == "moments_dropped":
            monkeypatch.setattr(torch.optim.Optimizer, "load_state_dict",
                                lambda self, state_dict: None)
        state, _ = cs.restore_trial_state(init_state, checkpoint, "cpu")
        monkeypatch.undo()
        restored_digest = cs.train_state_digest(state)
        for _ in range(cs.TUNE_CHECKPOINT_AT, cs.TUNE_STEPS):
            state, m = train_step(state, tokens)
            run.append(float(m["loss"]))
        assert run[:cs.TUNE_CHECKPOINT_AT + 1] == \
            ref[:cs.TUNE_CHECKPOINT_AT + 1]

        m = _libraries_report()
        m.update(reference_losses=ref, train_first_loss=ref[0])
        for row in m["rows"]:
            if row["lr"] == cs.TUNE_LRS[0]:
                row["loss"] = (run if losses == "run" else ref)[
                    row["step"] - 1]
                if "saved_digest" in row:
                    row["saved_digest"] = saved_digest
                if "restored_digest" in row:
                    row["restored_digest"] = restored_digest
        failed = [k for k, ok in cs.libraries_checks(m).items() if not ok]
        assert failed == ([] if accepted else ["resumed"])

    def test_launches_summed_over_trial_processes(self):
        rows = _libraries_report()["rows"]
        assert len(rows) == 15
        assert cs.sum_launches(rows) == {"flash_fwd": 24 * 15,
                                         "flash_bwd_dq": 12 * 15,
                                         "flash_bwd_dkv": 12 * 15}
        assert cs.sum_launches([]) == {}

    def test_trial_rows_and_summary(self, tmp_path):
        """Rows read from each trial's progress.jsonl, tagged with the
        trial; the summary a process each, the retry with its restore."""
        import json
        import types

        rows = _libraries_report()["rows"]
        grid = []
        for trial, pids in (("trial_a", (301, 302)), ("trial_b", (303,)),
                            ("trial_c", (304,)), ("trial_d", ())):
            path = tmp_path / trial
            path.mkdir()
            mine = [r for r in rows if r["pid"] in pids]
            if mine:
                (path / "progress.jsonl").write_text(
                    "".join(json.dumps(r) + "\n" for r in mine))
            grid.append(types.SimpleNamespace(path=str(path)))
        got = cs.trial_rows(grid)
        assert [r["trial"] for r in got] == ["trial_a"] * 8 + \
            ["trial_b"] * 3 + ["trial_c"] * 4
        assert [dict(r, trial=None) for r in got] == [
            dict(r, trial=None) for r in rows]
        summary = cs.trial_summary(got)
        assert [(s["pid"], s["steps"][0], s["restore_s"],
                 s["checkpoint_write_s"]) for s in summary] == [
            (301, 1, None, 1.5), (302, 5, 1.0, None), (303, 1, None, None),
            (304, 1, None, 1.5)]
        assert all(s["step_ms_median"] == pytest.approx(130.0)
                   for s in summary)

    def test_metrics_format(self):
        text = ("# HELP up x\n# TYPE up gauge\nup 1\n"
                'scheduler_queue_depth{node_id="ab"} 0.0\n\n'
                "bad line here\n")
        assert cs.metrics_format(text) == (3, ["bad line here"])

    def test_process_age(self):
        """This process's age from /proc: positive, and at least what
        it has lived since the test began."""
        t0 = time.perf_counter()
        time.sleep(0.05)
        age = cs.process_age_s()
        assert age >= time.perf_counter() - t0 - 0.02 and age > 0

    def test_phase_on_the_cpu(self, capsys):
        """The whole phase at a tiny width on the CPU, the head's GPU
        faked: every check but those that need the card (the trials'
        device count, the kernels' launches, the card's memory, the
        workflow step's K1) passes."""
        import json

        from ray_tpu_torch.models import GPTConfig

        cfg = GPTConfig.tiny()
        first = cs.uninterrupted_losses(cfg, "cpu", (2, 64),
                                        cs.TUNE_LRS[0], 1)[0]
        with pytest.raises(AssertionError) as err:
            cs.phase_libraries(first, cfg, "cpu", batch=(2, 64),
                               shape=(1, 2, 64, 16))
        assert "['pinned', 'launches', 'memory_back', 'workflow_k1']" in \
            str(err.value)
        (line,) = [x for x in capsys.readouterr().out.splitlines()
                   if x.startswith('{"phase": "libraries"')]
        m = json.loads(line)
        assert m["trial_processes"] == 3
        assert m["job"]["entrypoint_cuda_available"] == "False"
        assert [t["steps"][0] for t in m["trials"]] == [1, 5, 1]
