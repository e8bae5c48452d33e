"""The settling of a run's process before its window, and the host's own
readings over the window."""

import json
import os
import subprocess
import sys

import pytest

from perfbench.harness import hostenv
from perfbench.tests.conftest import ROOT


@pytest.mark.skipif(not hasattr(os, "sched_setaffinity"),
                    reason="needs os.sched_setaffinity")
def test_settle_freezes_and_keeps_the_driving_thread_on_one_core():
    # in a process of its own: the pin and the freeze last for the process
    code = ("import json, gc, os\n"
            "from perfbench.harness import hostenv\n"
            "keep = [[i] for i in range(1000)]\n"
            "out = hostenv.settle()\n"
            "out['affinity'] = sorted(os.sched_getaffinity(0))\n"
            "print(json.dumps(out))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                       capture_output=True, text=True)
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["frozen_objects"] >= 1000
    assert out["affinity"] == [out["driving_core"]]
    assert out["driving_core"] == max(os.sched_getaffinity(0))


def test_host_clock_reads_wall_and_thread_time():
    clock = hostenv.HostClock()
    clock.start()
    sum(i * i for i in range(200_000))
    out = clock.stop()
    assert out["wall_s"] > 0 and out["thread_cpu_s"] > 0
    assert out["thread_cpu_s"] <= out["wall_s"] * 1.05 + 1e-3
    assert out.get("host_steal_s", 0.0) >= 0.0
    json.dumps(out)
