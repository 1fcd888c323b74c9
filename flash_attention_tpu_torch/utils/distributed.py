"""Multi-process failure policy: init retries, fail-fast, and step watchdogs.

Counterpart of the JAX package's ``utils/distributed.py`` on
``torch.distributed``. Every process of a job must join the same
rendezvous, and a process that dies silently mid-step leaves every other
one blocked inside a collective with no error. The policy:

  * ``initialize_distributed`` — ``torch.distributed.init_process_group``
    (NCCL unless the caller names another backend) with bounded retries and
    exponential backoff (processes scheduled seconds apart race the
    rendezvous), then a check of the card count. Misconfiguration that no
    retry can fix raises at once.
  * ``fail_fast`` — wrap the step loop; any exception logs a one-line
    diagnosis and hard-exits the PROCESS (``os._exit``) so its peers fail
    their collectives promptly instead of hanging until the timeout.
  * ``StepWatchdog`` — a daemon thread armed per step; if a step exceeds its
    deadline (a hung collective or copy), it dumps all Python thread stacks
    to stderr and hard-exits.

All three are inert in single-process use; the tests drive them with mocks
and tiny deadlines. ``spawn_ranks`` runs one function as a group of local
processes (the CPU tests' gloo worlds, several ranks on one card).
"""

from __future__ import annotations

import faulthandler
import multiprocessing
import os
import queue
import sys
import tempfile
import threading
import time
import traceback
from contextlib import contextmanager

import torch
import torch.distributed as dist


class DistributedInitError(RuntimeError):
    """Raised when distributed initialization exhausts its retries."""


def _init_method(coordinator_address: str | None) -> str | None:
    """A rendezvous URL: the address itself when it names a scheme
    (``tcp://``, ``file://``, ``env://``), else ``tcp://<host:port>``."""
    if coordinator_address is None or "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str = "nccl",
    expected_local_devices: int | None = None,
    init_retries: int = 3,
    retry_delay_s: float = 2.0,
    backoff: float = 2.0,
    _initialize_fn=None,
) -> None:
    """``torch.distributed.init_process_group`` with retries, backoff, and
    validation.

    Args:
      coordinator_address: the rendezvous: ``host:port`` (TCP), or a URL
        with its scheme (``file:///path``). None reads the environment
        (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
      num_processes, process_id: the world size and this process's rank.
      backend: "nccl" (the cards) or "gloo" (the CPU, and the tests).
      expected_local_devices: if set, verify ``torch.cuda.device_count()``
        after init and raise DistributedInitError on a mismatch (a host that
        came up with a dead card must die now, not at the first collective).
      init_retries: attempts before giving up.
      retry_delay_s, backoff: exponential backoff between attempts.
      _initialize_fn: test hook (defaults to
        ``torch.distributed.init_process_group``), called with its keywords.
    """
    if init_retries < 1:
        raise ValueError(f"init_retries must be >= 1, got {init_retries}")
    init = _initialize_fn or dist.init_process_group
    kwargs = {"backend": backend}
    if coordinator_address is not None:
        kwargs["init_method"] = _init_method(coordinator_address)
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    delay = retry_delay_s
    last_err: Exception | None = None
    for attempt in range(1, init_retries + 1):
        try:
            init(**kwargs)
            break
        except Exception as e:  # noqa: BLE001 — any init failure is retryable
            last_err = e
            if attempt == init_retries:
                raise DistributedInitError(f"distributed init failed after {init_retries} attempts: {e!r}") from e
            print(
                f"[flash_attention_tpu_torch] distributed init attempt {attempt}/{init_retries} failed ({e!r}); "
                f"retrying in {delay:.1f}s",
                file=sys.stderr,
                flush=True,
            )
            time.sleep(delay)
            delay *= backoff
    if expected_local_devices is not None:
        got = torch.cuda.device_count()
        if got != expected_local_devices:
            raise DistributedInitError(
                f"host came up with {got} local devices, expected {expected_local_devices} — failing fast before "
                "the first collective hangs the job"
            )
    if last_err is not None:
        print("[flash_attention_tpu_torch] distributed init succeeded after retry", file=sys.stderr, flush=True)


@contextmanager
def fail_fast(context: str = "step loop", *, _exit_fn=None):
    """Hard-exit the process on any exception inside the block.

    One process raising and unwinding normally leaves the others blocked in
    collectives until their timeout (minutes). Exiting at once lets them
    error out in seconds. KeyboardInterrupt exits with the conventional 130;
    SystemExit (an intentional exit) unwinds normally.
    """
    exit_fn = _exit_fn or os._exit
    try:
        yield
    except SystemExit:
        raise
    except KeyboardInterrupt:
        print(f"[flash_attention_tpu_torch] interrupted in {context}; exiting", file=sys.stderr, flush=True)
        exit_fn(130)
    except BaseException as e:  # noqa: BLE001 — fail-fast means everything
        print(
            f"[flash_attention_tpu_torch] FATAL in {context}: {e!r} — hard-exiting so peer processes fail their "
            "collectives promptly",
            file=sys.stderr,
            flush=True,
        )
        # The exception's own traceback first (os._exit never unwinds, so
        # this is the only record of the raise site); dump_traceback shows
        # the other threads' stacks.
        traceback.print_exc(file=sys.stderr)
        faulthandler.dump_traceback(file=sys.stderr)
        exit_fn(1)


class StepWatchdog:
    """Detect hung steps (a stuck collective or copy) and kill the process.

    Usage::

        wd = StepWatchdog(deadline_s=300)
        for batch in data:
            with wd.step():
                loss = train_step(params, batch)
                torch.cuda.synchronize()
        wd.close()

    The watchdog thread wakes every ``poll_s``; if the current step has been
    running longer than ``deadline_s``, it dumps all thread stacks and
    hard-exits (exit code 2). Between steps the timer is disarmed.
    """

    def __init__(self, deadline_s: float, *, poll_s: float | None = None, _exit_fn=None):
        self.deadline_s = deadline_s
        self.poll_s = poll_s if poll_s is not None else min(deadline_s / 4, 10.0)
        self._exit_fn = _exit_fn or os._exit
        self._armed_at: float | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.fired = False  # observable by tests (with a mock exit)
        self._thread = threading.Thread(target=self._run, name="fat-step-watchdog", daemon=True)
        self._thread.start()

    @contextmanager
    def step(self):
        with self._lock:
            self._armed_at = time.monotonic()
        try:
            yield
        finally:
            with self._lock:
                self._armed_at = None

    def _run(self):
        while not self._stop.wait(self.poll_s):
            with self._lock:
                armed = self._armed_at
            if armed is None:
                continue
            elapsed = time.monotonic() - armed
            if elapsed > self.deadline_s:
                self.fired = True
                print(
                    f"[flash_attention_tpu_torch] step watchdog: step running {elapsed:.1f}s > deadline "
                    f"{self.deadline_s:.1f}s — dumping stacks and hard-exiting",
                    file=sys.stderr,
                    flush=True,
                )
                faulthandler.dump_traceback(file=sys.stderr)
                self._exit_fn(2)
                return  # only reached with a mock exit (tests)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)


def _rank_main(fn, args, rank: int, nprocs: int, backend: str, rendezvous: str, results) -> None:
    initialize_distributed(rendezvous, nprocs, rank, backend=backend, init_retries=1)
    try:
        results.put((rank, True, fn(*args)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, nprocs: int, *args, backend: str = "nccl", timeout_s: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``nprocs`` new processes (the spawn start method)
    joined into one process group of ``backend`` (rendezvous through a file
    in a temporary directory), and return each rank's result, by rank.

    ``fn`` and ``args`` are pickled (``fn`` by its import path) and each
    result comes back through a queue, so results hold CPU tensors, numpy
    arrays or plain values. A rank that raises, exits without a result or
    outlasts ``timeout_s`` fails the call with a RuntimeError naming it;
    every process is stopped before this returns or raises.
    """
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="fat_ranks.") as tmp:
        rendezvous = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=_rank_main, args=(fn, args, r, nprocs, backend, rendezvous, results))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        got, failures = {}, []
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < nprocs:
                try:
                    rank, ok, value = results.get(timeout=5.0)
                except queue.Empty:
                    if time.monotonic() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                        failures.append("a rank exited or timed out without a result")
                        break
                    continue
                if not ok:
                    failures.append(f"rank {rank}:\n{value}")
                    break
                got[rank] = value
        finally:
            for p in procs:  # the others may wait in a collective for the one that failed
                p.join(timeout=5 if failures else 60)
                if p.is_alive():
                    p.terminate()
                    p.join()
    if failures:
        raise RuntimeError("spawn_ranks: " + "\n".join(failures))
    return [got[r] for r in range(nprocs)]
