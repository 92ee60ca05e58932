"""The port's trial scheduler (veles_tpu_torch/parallel/trials.py): the
reference's tests/test_trials.py re-pointed at the port's placements.

Trials are subprocesses; the scheduler's contract is the reference's:
submission order kept, wall clock sublinear in the trials, failures and
overruns reported (an overrun killed with its process group), each
slot's placement env inside its trial. The placements are the port's:
``cpu_placement`` hides the card and forces the port's CPU backend with
one thread, ``mesh_slice_placement`` gives slot *i* the cards
``[i·d, (i+1)·d)`` through ``CUDA_VISIBLE_DEVICES``; a child that imports
the port reports what it sees and the backend it resolves.
"""
import json
import os
import sys
import time

import pytest

from veles_tpu_torch.parallel.trials import (Trial, TrialScheduler,
                                             cpu_placement,
                                             mesh_slice_placement,
                                             run_json_trials)
from torch_threads import one_torch_thread  # noqa: F401,E402

PY = sys.executable
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: -S skips site initialization: sleep-dominated trials then measure the
#: scheduler's concurrency, not the interpreter's start-up
NOSITE = [PY, "-S"]


def test_results_keep_submission_order_and_tags():
    sched = TrialScheduler(n_workers=3)
    results = sched.run([Trial(NOSITE + ["-c", "pass"], tag=i)
                         for i in range(7)])
    assert [r.tag for r in results] == list(range(7))
    assert all(r.ok for r in results)


def test_wallclock_sublinear_in_trials():
    """Six 1-second sleeps on three workers: serial is 6 s and more; the
    bound at 4.5 s passes only with real concurrency."""
    sched = TrialScheduler(n_workers=3)
    trials = [Trial(NOSITE + ["-c", "import time; time.sleep(1.0)"],
                    tag=i) for i in range(6)]
    t0 = time.time()
    results = sched.run(trials)
    elapsed = time.time() - t0
    assert all(r.ok for r in results)
    assert elapsed < 4.5, elapsed
    assert len({r.slot for r in results}) == 3


def test_failure_is_reported_not_raised():
    sched = TrialScheduler(n_workers=2)
    results = sched.run([
        Trial(NOSITE + ["-c", "pass"], tag="ok"),
        Trial(NOSITE + ["-c", "import sys; sys.exit(3)"], tag="bad"),
        Trial(NOSITE + ["-c", "raise RuntimeError('boom')"], tag="boom"),
    ])
    assert results[0].ok
    assert not results[1].ok and results[1].returncode == 3
    assert not results[2].ok and "boom" in results[2].stderr_tail


def test_overrunning_trial_is_killed_by_group():
    """A hung trial is killed with its grandchildren and reported as
    timed out."""
    sched = TrialScheduler(n_workers=2)
    t0 = time.time()
    results = sched.run([
        Trial(NOSITE + ["-c",
                        "import subprocess, sys, time;"
                        "subprocess.Popen([sys.executable, '-S', '-c',"
                        " 'import time; time.sleep(60)']);"
                        "time.sleep(60)"], tag="hang", timeout=2.0),
        Trial(NOSITE + ["-c", "pass"], tag="ok"),
    ])
    assert time.time() - t0 < 30
    assert results[0].timed_out and not results[0].ok
    assert results[1].ok


def test_placement_env_reaches_the_trial(tmp_path):
    out = tmp_path / "envs"
    out.mkdir()
    sched = TrialScheduler(
        n_workers=2,
        placement=lambda slot: {"TRIAL_SLOT": str(slot),
                                "VELES_BACKEND": "cpu"})
    script = ("import os; open(%r + '/' + os.environ['TRIAL_SLOT'], 'a')"
              ".write(os.environ['VELES_BACKEND'] + '\\n')" % str(out))
    results = sched.run([Trial(NOSITE + ["-c", script], tag=i)
                         for i in range(6)])
    assert all(r.ok for r in results), [r.stderr_tail for r in results]
    assert sorted(os.listdir(out)) == ["0", "1"]
    assert (out / "0").read_text().strip().splitlines()[0] == "cpu"


def test_cpu_placement_hides_the_card_and_pins_one_thread():
    env = cpu_placement(0)
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert env["VELES_BACKEND"] == "cpu"
    assert env["OMP_NUM_THREADS"] == "1"
    assert cpu_placement(3) == env


def test_mesh_slice_placement_disjoint_slices():
    place = mesh_slice_placement(devices_per_trial=2, total_devices=8)
    assert place(0)["CUDA_VISIBLE_DEVICES"] == "0,1"
    assert place(3)["CUDA_VISIBLE_DEVICES"] == "6,7"
    with pytest.raises(ValueError):
        place(4)


def test_worker_count_validation():
    with pytest.raises(ValueError):
        TrialScheduler(n_workers=0)
    assert isinstance(TrialScheduler(n_workers=2).run([]), list)

    # a slot past the host's last card raises before any trial runs
    def spawned(*_a, **_k):
        raise AssertionError("a trial ran")
    sched = TrialScheduler(n_workers=2, placement=mesh_slice_placement(
        1, total_devices=1))
    sched._run_one = spawned
    with pytest.raises(ValueError, match="only 1 exist"):
        sched.run([Trial(NOSITE + ["-c", "pass"], tag=i) for i in range(2)])


#: a trial that imports the port and reports what it was given: the
#: visible cards, the backend the port resolves and its thread count
CHILD = (
    "import json, os, sys\n"
    "sys.path.insert(0, %r)\n"
    "import torch\n"
    "from veles_tpu_torch.backends import device_for_backend\n"
    "json.dump({'cards': os.environ.get('CUDA_VISIBLE_DEVICES'),\n"
    "           'n_cards': torch.cuda.device_count(),\n"
    "           'device': str(device_for_backend(None)),\n"
    "           'threads': torch.get_num_threads()},\n"
    "          open(sys.argv[1], 'w'))\n" % REPO)


def test_placement_child_sees_exact_slice(tmp_path):
    """A port trial placed by ``mesh_slice_placement`` sees exactly its
    slice (slot i ↔ cards [2i, 2i+1]); one placed by ``cpu_placement``
    sees no card and resolves the CPU with one thread. On this host no
    card exists, so the slice is proved by the env the child reads."""
    sched = TrialScheduler(
        n_workers=2, placement=mesh_slice_placement(devices_per_trial=2,
                                                    total_devices=4))
    results = sched.run([
        Trial([PY, "-c", CHILD, str(tmp_path / ("t%d.json" % i))], tag=i,
              env={"VELES_BACKEND": "cpu"}) for i in range(4)])
    assert all(r.ok for r in results), [r.stderr_tail for r in results]
    by_slot = {0: "0,1", 1: "2,3"}
    for i, res in enumerate(results):
        doc = json.load(open(tmp_path / ("t%d.json" % i)))
        assert doc["cards"] == by_slot[res.slot], (doc, res.slot)
        assert doc["device"] == "cpu"
    assert {r.slot for r in results} == {0, 1}

    docs = run_json_trials(lambda i, rf: [PY, "-c", CHILD, rf], n=2,
                           n_workers=2, placement=cpu_placement)
    for res, doc in docs:
        assert res.ok, res.stderr_tail
        assert doc == {"cards": "", "n_cards": 0, "device": "cpu",
                       "threads": 1}
