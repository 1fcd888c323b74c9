"""The kernel wrappers' launch counters, in one registry.

A wrapper counts each launch of its kernel in an attribute of its own
(``decode_attention.launches``, ``paged_write_tokens_multi.quant_launches``,
...). It creates that attribute through ``counter`` (or ``body_counter``),
which also registers it here: under the kernel's name (K6, K7q, ...), with
the CUDA functions its launches run (``decode_kernel``: the name a device
trace gives the launch). Whatever reads or adds to the counts reads this
registry and no list of its own: ``serving.decode_loop.DecodePrograms``
(a replayed CUDA graph launches what its capture counted) and
``chip_smoke.py``'s checks, which also hold the counts against the kernel
records of a device trace (``functions``).

The forward wrappers count their launches a second time by body,
``tensor_core_launches`` (csrc/flash_fwd_sm90.cu) and ``fma_launches``
(csrc/flash_fwd.cu): those are ``BODIES``, named "<kernels> <body>".
"""

from __future__ import annotations

import re

# kernel name -> (wrapper, attribute, the CUDA functions its launches run)
KERNELS: dict[str, tuple[object, str, tuple[str, ...]]] = {}
# "<kernels> <body>" -> (wrapper, attribute)
BODIES: dict[str, tuple[object, str]] = {}


def counter(fn, attr: str, name: str, *functions: str) -> None:
    """Create ``fn.<attr> = 0``, the count of kernel ``name``'s launches,
    which run the CUDA ``functions``."""
    setattr(fn, attr, 0)
    KERNELS[name] = (fn, attr, functions)


def body_counter(fn, attr: str, name: str) -> None:
    """Create ``fn.<attr> = 0``, the count of ``fn``'s launches on one body."""
    setattr(fn, attr, 0)
    BODIES[name] = (fn, attr)


def _all() -> list[tuple[object, str]]:
    return [(fn, attr) for fn, attr, *_ in (*KERNELS.values(), *BODIES.values())]


def snapshot() -> dict:
    """Every registered count, by (wrapper, attribute)."""
    return {(fn, attr): getattr(fn, attr) for fn, attr in _all()}


def add(counts: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``counts`` (by (wrapper, attribute)) to the counts."""
    for (fn, attr), n in counts.items():
        setattr(fn, attr, getattr(fn, attr) + sign * n)


def zero() -> None:
    for fn, attr in _all():
        setattr(fn, attr, 0)


def read() -> dict:
    """The kernels' counts, by kernel name."""
    return {name: getattr(fn, attr) for name, (fn, attr, _) in KERNELS.items()}


def read_bodies() -> dict:
    """The forward launches by "<kernels> <body>"."""
    return {name: getattr(fn, attr) for name, (fn, attr) in BODIES.items()}


def functions() -> dict[tuple[str, ...], tuple[str, ...]]:
    """The registered kernels grouped by the CUDA functions they run: one
    group's launches are told apart in a device trace only by template
    arguments, so a trace is held against the group's summed count."""
    groups: dict[tuple[str, ...], list[str]] = {}
    for name, (_, _, fns) in KERNELS.items():
        groups.setdefault(fns, []).append(name)
    return {fns: tuple(names) for fns, names in groups.items()}


def traced(names) -> dict[tuple[str, ...], int]:
    """The kernel records among a device trace's operation ``names`` (one
    name a record), by group of registered kernels (``functions``): a
    record whose name is a call of one of the group's CUDA functions, as
    ``void (anonymous namespace)::decode_kernel<...>(DecodeParams)`` is."""
    out = {}
    for fns, kernels in functions().items():
        pattern = re.compile(r"(?:^|[\s:])(?:" + "|".join(map(re.escape, fns)) + r")[<(]")
        out[kernels] = sum(1 for name in names if pattern.search(name))
    return out
