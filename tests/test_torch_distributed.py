"""The port's --distributed (torch.distributed, gloo) on the CPU, the
counterpart of tests/test_distributed.py and of test_sharding.py's counter
test: real processes form a group over 127.0.0.1, the videolist shards
disjointly between them, host 0 prints the global summary from the counter
all-reduce, a host with an empty shard still joins it, and the files are
those of one process. Every subprocess has a timeout, so a hang fails the
test instead of the run.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from conftest import make_translating_video
from denseflow_tpu.parallel import distributed as jdist
from denseflow_tpu.utils import Counters as JCounters
from denseflow_tpu_torch.cli import main
from denseflow_tpu_torch.parallel import distributed as tdist
from denseflow_tpu_torch.utils import Counters

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 240  # s, each group of processes
_TOPOLOGY_ENV = ("DENSEFLOW_NUM_PROCESSES", "DENSEFLOW_PROCESS_ID", "WORLD_SIZE",
                 "RANK", "MASTER_ADDR", "MASTER_PORT")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _TOPOLOGY_ENV}
    # gloo's sockets on the loopback too, beside the coordinator
    env.update(OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo", **extra)
    return env


def _run_all(cmds_envs) -> list:
    """Start every (argv, env) at once and wait for all within TIMEOUT;
    kill them all if one hangs. Returns [(rc, stdout, stderr)]."""
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd, env in cmds_envs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out, err))
        return outs
    except subprocess.TimeoutExpired:
        for p in procs[len(outs):]:
            p.kill()
            out, err = p.communicate()
            outs.append(("killed", out, err))
        raise AssertionError(f"a process ran past {TIMEOUT} s: " + "\n".join(
            f"rc={rc}\n{out[-800:]}\n{err[-800:]}" for rc, out, err in outs))


def _hosts(args, n=2) -> list:
    """`python -m denseflow_tpu_torch <args> --distributed` as n hosts."""
    port = _free_port()
    cmd = [sys.executable, "-m", "denseflow_tpu_torch", *args, "--device=cpu",
           "--distributed", f"--coordinator=127.0.0.1:{port}"]
    outs = _run_all([(cmd, _clean_env(DENSEFLOW_NUM_PROCESSES=str(n),
                                      DENSEFLOW_PROCESS_ID=str(r))) for r in range(n)])
    for rc, out, err in outs:
        assert rc == 0, f"rc={rc}\n{out[-800:]}\n{err[-800:]}"
    return [out for _, out, _ in outs]


def _files(root: Path) -> dict:
    return {str(f.relative_to(root)): f.read_bytes()
            for f in sorted(root.rglob("*.jpg"))}


# ---------------- one process ----------------

def test_allreduce_counters_single_process():
    c, jc = Counters(), JCounters()
    for cnt in (c, jc):
        cnt.add_videos(2)
        cnt.add_frames(100)
        cnt.add_flows(98)
    assert tdist.allreduce_counters(c) == jdist.allreduce_counters(jc) == (2, 100, 98)


def test_one_process_runs_without_a_group(monkeypatch):
    for k in _TOPOLOGY_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("DENSEFLOW_NUM_PROCESSES", "1")
    assert tdist.init_distributed() == jdist.init_distributed() == (0, 1)
    assert tdist.init_distributed(num_processes=1, process_id=0) == (0, 1)
    assert not dist.is_initialized()


@pytest.mark.parametrize("env,kw,match", [
    ({}, {}, "DENSEFLOW_NUM_PROCESSES"),
    ({"DENSEFLOW_NUM_PROCESSES": "2"}, {}, "no process id"),
    ({"DENSEFLOW_NUM_PROCESSES": "2", "DENSEFLOW_PROCESS_ID": "1"}, {},
     "no coordinator"),
    ({"WORLD_SIZE": "2", "RANK": "0"}, {}, "no coordinator"),
    ({}, {"num_processes": 3}, "no process id"),
])
def test_missing_topology_raises(monkeypatch, env, kw, match):
    """Never a quiet single-host run: the error names what to set."""
    for k in _TOPOLOGY_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        tdist.init_distributed(**kw)
    assert not dist.is_initialized()


def test_cli_without_topology_fails_before_work(monkeypatch, tmp_path, capsys):
    for k in _TOPOLOGY_ENV:
        monkeypatch.delenv(k, raising=False)
    path, _ = make_translating_video(tmp_path / "v.avi", h=32, w=40, n=3, dx=1)
    assert main([path, f"-o={tmp_path / 'out'}", "-s=1", "--distributed",
                 "--device=cpu"]) == 1
    assert "DENSEFLOW_NUM_PROCESSES" in capsys.readouterr().out
    assert not (tmp_path / "out").exists()


# ---------------- two processes ----------------

def test_two_process_distributed_run(tmp_path):
    """tests/test_distributed.py:36-81, and the files of one process."""
    vids = [make_translating_video(tmp_path / f"v{i}.avi", h=48, w=64, n=5, dx=1, seed=i)[0]
            for i in range(2)]
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(vids) + "\n")
    out = tmp_path / "out"
    outs = _hosts([str(lst), f"-o={out}", "-s=1", "--pairBatch=4", "-v"])
    # disjoint video sharding: host 0 round-robins to v0, host 1 to v1
    assert "v0.avi" in outs[0] and "v1.avi" not in outs[0]
    assert "v1.avi" in outs[1] and "v0.avi" not in outs[1]
    # both videos completed (shared .done dir)
    assert (out / ".done" / "v0").is_file() and (out / ".done" / "v1").is_file()
    # the global summary: printed exactly once, by host 0, with the summed
    # counters (2 videos x 5 frames, 4 flows each)
    assert "2 videos (10 frames, 8 tvl1 flows)" in outs[0]
    assert "flows) processed" not in outs[1]
    # the same files as one process running the whole list
    assert main([str(lst), f"-o={tmp_path / 'one'}", "-s=1", "--pairBatch=4",
                 "--device=cpu"]) == 0
    two, one = _files(out), _files(tmp_path / "one")
    assert len(one) == 16 and two == one


def test_distributed_empty_shard_still_joins_allreduce(tmp_path):
    """1 video over 2 hosts: the jobless host must still reach the final
    counter all-reduce, or the working host waits in the collective."""
    p, _ = make_translating_video(tmp_path / "only.avi", h=48, w=64, n=5, dx=1)
    lst = tmp_path / "list.txt"
    lst.write_text(p + "\n")
    outs = _hosts([str(lst), f"-o={tmp_path / 'out'}", "-s=1", "--pairBatch=4"])
    assert "1 videos (5 frames, 4 tvl1 flows)" in outs[0]
    assert "flows) processed" not in outs[1]
    assert (tmp_path / "out" / ".done" / "only").is_file()


_LAUNCHED = """
from denseflow_tpu_torch.parallel.distributed import (
    allreduce_counters, init_distributed, shutdown_distributed)
from denseflow_tpu_torch.utils import Counters
import torch.distributed as dist
host, n = init_distributed()
assert init_distributed() == (host, n)  # a second call only returns the topology
c = Counters()
c.add_videos(1)
c.add_frames(10 * (host + 1))
c.add_flows(host)
print("topology", host, n, "sum", *allreduce_counters(c))
shutdown_distributed()
print("left the group:", not dist.is_initialized())
"""


def test_launcher_environment_joins_and_sums():
    """torchrun's WORLD_SIZE / RANK / MASTER_ADDR / MASTER_PORT through env://."""
    port = str(_free_port())
    cmd = [sys.executable, "-c", _LAUNCHED]
    outs = _run_all([(cmd, _clean_env(WORLD_SIZE="2", RANK=str(r), MASTER_ADDR="127.0.0.1",
                                      MASTER_PORT=port)) for r in range(2)])
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-800:]
        assert f"topology {r} 2 sum 2 30 1" in out and "left the group: True" in out
