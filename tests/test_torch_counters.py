"""The kernel wrappers' launch counters (``ops/counters.py``), on the CPU.

Every counter a wrapper of the port keeps (an attribute named
``*launches``) is in the one registry that ``DecodePrograms`` and
``chip_smoke.py`` read, so a replayed decode program adds to every count
its capture took. The registry names each kernel once, and its device-trace
matcher finds a kernel's records by the CUDA function they call, apart
from functions whose names contain another's.
"""

import importlib
import pathlib

import pytest

import flash_attention_tpu_torch as port
from flash_attention_tpu_torch.ops import counters

KERNELS = {"K1", "K2", "K1d", "K1q", "K1r", "K3", "K4", "K5", "K3m", "K4m", "K5m", "K5s", "K6", "K6q", "K7", "K7q", "K8", "K8q",
           "K9/K10", "K9q/K10q", "PT", "PS", "F1", "F2", "F2c", "F3", "W1", "W2", "S1"}


def _modules():
    """Every module of the port, namespace packages' (tools/) included."""
    root = pathlib.Path(port.__file__).parent
    names = (".".join((port.__name__, *p.relative_to(root).with_suffix("").parts)) for p in sorted(root.rglob("*.py")))
    return [importlib.import_module(name.removesuffix(".__init__")) for name in names]


def test_every_launch_counter_is_registered():
    found = {
        (id(obj), attr): f"{module.__name__}.{name}.{attr}"
        for module in _modules()
        for name, obj in vars(module).items()
        if callable(obj) and getattr(obj, "__module__", None) == module.__name__
        for attr in getattr(obj, "__dict__", {})
        if attr.endswith("launches") and isinstance(getattr(obj, attr), int)
    }
    registered = {(id(fn), attr) for fn, attr in counters._all()}
    assert len(registered) == len(counters.KERNELS) + len(counters.BODIES)
    assert sorted(found[key] for key in found.keys() - registered) == []
    assert registered <= found.keys()


def test_the_registry_names_each_kernel_once():
    _modules()
    assert set(counters.KERNELS) == KERNELS
    assert set(counters.BODIES) == {"K1/K1d/K2 tensor_core", "K1/K1d/K2 fma", "K1q/K1r tensor_core", "K1q/K1r fma",
                                    "K1q/K1r cluster", "K8/K8q tensor_core", "K8/K8q fma", "K7/K7q self"}
    groups = counters.functions()
    assert groups[("decode_kernel",)] == ("K6", "K6q", "K7", "K7q")
    assert sorted(k for kernels in groups.values() for k in kernels) == sorted(KERNELS)


@pytest.mark.parametrize("name, group", [
    ("void (anonymous namespace)::decode_kernel<__nv_bfloat16, __nv_bfloat16, 128, false, false>(DecodeParams)",
     ("K6", "K6q", "K7", "K7q")),
    ("(anonymous namespace)::paged_write_kernel(WriteParams)", ("K9/K10",)),
    ("void (anonymous namespace)::paged_write_quant_kernel<__nv_bfloat16, signed char>(QuantWriteParams)",
     ("K9q/K10q",)),
    ("void fwd_kernel<__half, __half, 128, true, 2, false>(Params)", ("K1", "K2", "K1d", "K1q", "K1r", "K8", "K8q")),
    ("void (anonymous namespace)::chunk_fwd_kernel<__nv_bfloat16, signed char, 128, false>(ChunkParams)",
     ("K1", "K2", "K1d", "K1q", "K1r", "K8", "K8q")),
    ("void flash_bwd_dq_kernel<float, 64, false>(BwdParams)", ("K4", "K4m")),
    ("void split_sum_kernel<__nv_bfloat16>(float const*, __nv_bfloat16*, __nv_bfloat16*, int, int, int)", ("K5s",)),
    ("void (anonymous namespace)::add_rms_norm_kernel<__nv_bfloat16>(NormParams)", ("F1",)),
    ("void (anonymous namespace)::rope_kernel<__nv_bfloat16, signed char>(RopeParams)", ("F2",)),
    ("void (anonymous namespace)::rope_chunk_kernel<__nv_bfloat16, signed char, 128>(ChunkParams)", ("F2c",)),
    ("void (anonymous namespace)::swiglu_act_kernel<float>(float const*, float const*, float*, long)", ("F3",)),
    ("void (anonymous namespace)::w8_gemv_kernel<__nv_bfloat16, true, 1, true>(GemvParams)", ("W1",)),
    ("(anonymous namespace)::w8_gemv_fma_kernel(GemvParams)", ("W1",)),
    ("void (anonymous namespace)::w8_gemm_kernel<__half, false>(GemmParams)", ("W2",)),
    ("(anonymous namespace)::sample_kernel(SampleParams)", ("S1",)),
    ("nvjet_tst_128x8_64x12_4x1_v_bz_NNT", None),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl<...>>(int, ...)", None),
])
def test_a_trace_record_counts_for_its_kernels_only(name, group):
    _modules()
    got = {kernels: n for kernels, n in counters.traced([name, name]).items() if n}
    assert got == ({} if group is None else {group: 2})


def test_snapshot_and_add_move_every_count():
    _modules()
    before = counters.snapshot()
    counts = {key: 3 for key in before}
    counters.add(counts)
    try:
        assert counters.snapshot() == {key: n + 3 for key, n in before.items()}
    finally:
        counters.add(counts, -1)
    assert counters.snapshot() == before
