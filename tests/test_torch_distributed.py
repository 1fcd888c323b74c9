"""The port's multi-process failure policy (utils/distributed.py), driven
with mocks: the JAX package's tests/test_distributed.py cases on the port.

Init retries with backoff, the fail-fast process exit, and the hung-step
watchdog. A real multi-host job cannot run here; the contracts (retry
counts, the keywords handed to ``init_process_group``, exit codes, deadline
firing) can. One more case starts a two-rank gloo group through
``spawn_ranks`` and reads a rank's failure back.
"""

import time

import pytest
import torch

from flash_attention_tpu_torch.utils.distributed import (
    DistributedInitError,
    StepWatchdog,
    fail_fast,
    initialize_distributed,
    spawn_ranks,
)


def test_init_retries_then_succeeds(monkeypatch):
    calls = []

    def flaky(**kwargs):
        calls.append(kwargs)
        if len(calls) < 3:
            raise RuntimeError("coordinator not up yet")

    monkeypatch.setattr(time, "sleep", lambda s: None)
    initialize_distributed(
        coordinator_address="host:1234", num_processes=4, process_id=1,
        init_retries=3, retry_delay_s=0.0, _initialize_fn=flaky,
    )
    assert len(calls) == 3
    assert calls[0] == {"backend": "nccl", "init_method": "tcp://host:1234", "world_size": 4, "rank": 1}


def test_init_exhausts_retries(monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)

    def always_fails(**kwargs):
        raise RuntimeError("bad address")

    with pytest.raises(DistributedInitError, match="after 2 attempts"):
        initialize_distributed(
            coordinator_address="nowhere:1", init_retries=2,
            retry_delay_s=0.0, _initialize_fn=always_fails,
        )


def test_init_validates_device_count():
    with pytest.raises(DistributedInitError, match="local devices"):
        initialize_distributed(
            expected_local_devices=torch.cuda.device_count() + 7,
            _initialize_fn=lambda **kw: None,
        )


def test_fail_fast_exits_on_exception():
    codes = []
    with fail_fast("unit test", _exit_fn=codes.append):
        raise ValueError("boom")
    assert codes == [1]


def test_fail_fast_interrupt_code():
    codes = []
    with fail_fast("unit test", _exit_fn=codes.append):
        raise KeyboardInterrupt()
    assert codes == [130]


def test_fail_fast_clean_block_no_exit():
    codes = []
    with fail_fast("unit test", _exit_fn=codes.append):
        pass
    assert codes == []


def test_watchdog_fires_on_hung_step():
    codes = []
    wd = StepWatchdog(deadline_s=0.2, poll_s=0.05, _exit_fn=codes.append)
    try:
        with wd.step():
            deadline = time.monotonic() + 2.0
            while not wd.fired and time.monotonic() < deadline:
                time.sleep(0.02)
    finally:
        wd.close()
    assert wd.fired and codes == [2]


def test_watchdog_quiet_on_fast_steps():
    codes = []
    wd = StepWatchdog(deadline_s=0.5, poll_s=0.05, _exit_fn=codes.append)
    try:
        for _ in range(5):
            with wd.step():
                time.sleep(0.01)
        time.sleep(0.2)  # disarmed between steps: must not fire
    finally:
        wd.close()
    assert not wd.fired and codes == []


def test_fail_fast_lets_system_exit_through():
    """sys.exit is an intentional shutdown, not a failure: it must unwind
    normally instead of becoming a FATAL hard-exit(1)."""
    codes = []
    with pytest.raises(SystemExit) as ei:
        with fail_fast("unit test", _exit_fn=codes.append):
            raise SystemExit(0)
    assert ei.value.code == 0
    assert codes == []


def test_init_rejects_zero_retries():
    with pytest.raises(ValueError, match="init_retries"):
        initialize_distributed(init_retries=0)


def test_init_method_keeps_a_url():
    calls = []
    initialize_distributed("file:///tmp/rendezvous", 2, 0, backend="gloo", _initialize_fn=lambda **kw: calls.append(kw))
    assert calls == [{"backend": "gloo", "init_method": "file:///tmp/rendezvous", "world_size": 2, "rank": 0}]


def _rank_and_sum(fail_rank):
    import torch.distributed as dist

    if dist.get_rank() == fail_rank:
        raise ValueError(f"rank {fail_rank} fails on purpose")
    t = torch.tensor([dist.get_rank() + 1.0])
    dist.all_reduce(t)
    return dist.get_rank(), dist.get_world_size(), float(t)


def test_spawn_ranks_returns_by_rank_and_reports_a_failing_rank():
    assert spawn_ranks(_rank_and_sum, 2, -1, backend="gloo", timeout_s=120) == [(0, 2, 3.0), (1, 2, 3.0)]
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_ranks(_rank_and_sum, 2, 1, backend="gloo", timeout_s=120)
