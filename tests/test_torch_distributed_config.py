"""The port's multi-process init against ``ser_tpu.parallel.distributed``, on the CPU.

- ``is_multi_host_env`` and ``resolve_distributed_kwargs`` give the JAX
  package's answers for the same ``SER_DIST_*`` environments, and its
  refusals with the same messages (a partial triple, a non-integer value, a
  bad topology); the kwargs become ``init_process_group``'s
  (``tcp://<coordinator>``, world size, rank). The two deliberate
  differences: Cloud TPU's ``TPU_WORKER_HOSTNAMES`` means nothing here, and
  torchrun's ``WORLD_SIZE`` > 1 with ``MASTER_ADDR`` takes its place.
- ``initialize_distributed`` over a world-size-1 gloo group: False in a
  single-process environment, True and idempotent (also from racing
  threads), adopting a group someone else formed, and raising with no card
  unless ``SER_TORCH_DEVICE=cpu`` asks for the CPU.
- a two-process gloo loopback through ``SER_DIST_*`` with one ``all_gather``,
  the counterpart of ``tests/suites/integration/parallel/test_distributed_loopback.py``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from ser_tpu.parallel import distributed as jax_distributed
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError
from ser_tpu_torch.parallel import distributed

REPO = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_world(script: Path, args: list[str], world: int, env: dict[str, str], timeout: float = WORLD_TIMEOUT_S):
    """Runs ``script`` as ``world`` gloo ranks on the CPU (``SER_DIST_*``, ``SER_TORCH_DEVICE=cpu``,
    ``PYTHONPATH`` and the working directory at the repo root); returns each rank's output and raises
    if one fails. Every rank is killed at ``timeout``: a hung collective fails the caller, not the suite.
    """
    port = _free_port()
    processes = []
    for rank in range(world):
        rank_env = {
            **os.environ,
            "SER_TORCH_DEVICE": "cpu",
            "OMP_NUM_THREADS": "1",
            **env,
            "SER_DIST_COORDINATOR": f"127.0.0.1:{port}",
            "SER_DIST_NUM_PROCESSES": str(world),
            "SER_DIST_PROCESS_ID": str(rank),
            "PYTHONPATH": str(REPO),
        }
        processes.append(
            subprocess.Popen(
                [sys.executable, str(script), *args], cwd=REPO, env=rank_env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        )
    outputs, failed = [], []
    try:
        for rank, process in enumerate(processes):
            try:
                output, _ = process.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                failed.append(f"rank {rank} timed out after {timeout} s")
                break
            outputs.append(output)
            if process.returncode != 0:
                failed.append(f"rank {rank} exited {process.returncode}:\n{output[-3000:]}")
    finally:
        for process in processes:
            if process.poll() is None:
                process.kill()
                process.communicate()
    if failed:
        raise AssertionError("\n".join(failed))
    return outputs


_SHARED_ENVS = [
    {},
    {"SER_DIST_COORDINATOR": ""},
    {"SER_DIST_COORDINATOR": "10.0.0.1:1234", "SER_DIST_NUM_PROCESSES": "4", "SER_DIST_PROCESS_ID": "3"},
    {"SER_DIST_COORDINATOR": "host:99", "SER_DIST_NUM_PROCESSES": " 2 ", "SER_DIST_PROCESS_ID": "0"},
    {"SER_DIST_COORDINATOR": "host:99", "SER_DIST_NUM_PROCESSES": "2"},
    {"SER_DIST_COORDINATOR": "host:99", "SER_DIST_PROCESS_ID": "0"},
    {"SER_DIST_COORDINATOR": "host:99", "SER_DIST_NUM_PROCESSES": "", "SER_DIST_PROCESS_ID": ""},
    {"SER_DIST_COORDINATOR": "host:99", "SER_DIST_NUM_PROCESSES": "two", "SER_DIST_PROCESS_ID": "0"},
    {"SER_DIST_COORDINATOR": "host:99", "SER_DIST_NUM_PROCESSES": "2", "SER_DIST_PROCESS_ID": "2"},
    {"SER_DIST_COORDINATOR": "host:99", "SER_DIST_NUM_PROCESSES": "0", "SER_DIST_PROCESS_ID": "0"},
    {"SER_DIST_COORDINATOR": "host:99", "SER_DIST_NUM_PROCESSES": "2", "SER_DIST_PROCESS_ID": "-1"},
    {"TPU_WORKER_HOSTNAMES": "solo"},
]


@pytest.mark.parametrize("env", _SHARED_ENVS, ids=range(len(_SHARED_ENVS)))
def test_config_parsing_matches_jax(env) -> None:
    assert distributed.is_multi_host_env(env) == jax_distributed.is_multi_host_env(env)
    try:
        theirs = jax_distributed.resolve_distributed_kwargs(env)
    except ValueError as err:
        with pytest.raises(ValueError) as ours:
            distributed.resolve_distributed_kwargs(env)
        assert str(ours.value) == str(err)
        return
    ours = distributed.resolve_distributed_kwargs(env)
    if not theirs:
        assert ours == {}
        return
    assert ours == {
        "init_method": f"tcp://{theirs['coordinator_address']}",
        "world_size": theirs["num_processes"],
        "rank": theirs["process_id"],
    }


def test_torchrun_env_takes_the_place_of_cloud_tpu_detection() -> None:
    pod = {"TPU_WORKER_HOSTNAMES": "a,b,c"}
    assert jax_distributed.is_multi_host_env(pod) and not distributed.is_multi_host_env(pod)
    torchrun = {"WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1234", "RANK": "1"}
    assert distributed.is_multi_host_env(torchrun) and not jax_distributed.is_multi_host_env(torchrun)
    assert distributed.resolve_distributed_kwargs(torchrun) == {}  # init_method="env://"
    for env in ({"WORLD_SIZE": "1", "MASTER_ADDR": "h"}, {"WORLD_SIZE": "4"}, {"WORLD_SIZE": "x", "MASTER_ADDR": "h"}):
        assert not distributed.is_multi_host_env(env)


@pytest.fixture
def single_process(monkeypatch):
    """A world-size-1 ``SER_DIST_*`` environment on the CPU; every group is destroyed afterwards."""
    for name in ("SER_DIST_COORDINATOR", "SER_DIST_NUM_PROCESSES", "SER_DIST_PROCESS_ID", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SER_TORCH_DEVICE", "cpu")
    assert not dist.is_initialized()
    yield monkeypatch
    distributed.shutdown_distributed()


def _set_world_of_one(monkeypatch) -> None:
    monkeypatch.setenv("SER_DIST_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("SER_DIST_NUM_PROCESSES", "1")
    monkeypatch.setenv("SER_DIST_PROCESS_ID", "0")


def test_initialize_is_a_no_op_alone_and_idempotent_with_a_world_of_one(single_process) -> None:
    assert distributed.initialize_distributed() is False
    assert not dist.is_initialized()
    _set_world_of_one(single_process)
    results: list[bool] = []
    threads = [threading.Thread(target=lambda: results.append(distributed.initialize_distributed())) for _ in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert results == [True] * 4
    assert dist.is_initialized() and dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert distributed.initialize_distributed() is True


def test_initialize_adopts_a_group_formed_elsewhere(single_process) -> None:
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    assert distributed.initialize_distributed(force=True) is True
    assert dist.get_world_size() == 1


def test_initialize_without_a_card_or_a_cpu_request_raises(single_process) -> None:
    assert not torch.cuda.is_available()
    _set_world_of_one(single_process)
    single_process.delenv("SER_TORCH_DEVICE")
    with pytest.raises(RuntimeDependencyError, match="SER_TORCH_DEVICE=cpu"):
        distributed.initialize_distributed()
    assert not dist.is_initialized()


_LOOPBACK = textwrap.dedent(
    """
    import torch
    import torch.distributed as dist

    from ser_tpu_torch.parallel.distributed import initialize_distributed, is_multi_host_env, shutdown_distributed

    assert is_multi_host_env(), "SER_DIST_* env must mark this process multi-host"
    assert initialize_distributed() is True
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    rank = dist.get_rank()
    gathered = [torch.zeros(1) for _ in range(2)]
    dist.all_gather(gathered, torch.tensor([float(rank + 1)]))
    assert torch.cat(gathered).tolist() == [1.0, 2.0], gathered
    print(f"OK rank={rank}")
    shutdown_distributed()
    """
)


def test_two_process_loopback_initializes_and_allgathers(tmp_path) -> None:
    script = tmp_path / "worker.py"
    script.write_text(_LOOPBACK)
    outputs = run_world(script, [], 2, {})
    assert [line for out in outputs for line in out.splitlines() if line.startswith("OK")] == [
        "OK rank=0",
        "OK rank=1",
    ]
