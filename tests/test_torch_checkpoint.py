"""The port's checkpoint/resume (``workflow/checkpoint.py``, ``train_als``'s
hook, ``Engine.train``'s per-algorithm scoping and the console's
``--checkpoint-every`` / ``--resume``) on the CPU, mirroring
``tests/test_checkpoint.py`` and held against the JAX reference: the
chunked and resumed trains are bit-identical to one unchunked run of the
port, within 2e-4 of the reference's ``train_als``, and the snapshot's data
fingerprint is the one the reference writes for the same triple.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from incubator_predictionio_tpu.ops import als as ref_als  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import mesh_from_devices  # noqa: E402
from incubator_predictionio_tpu.workflow import checkpoint as ref_ckpt  # noqa: E402
from incubator_predictionio_torch.controller import Engine, EngineParams  # noqa: E402
from incubator_predictionio_torch.models import recommendation as port_rec  # noqa: E402
from incubator_predictionio_torch.ops import als as port_als  # noqa: E402
from incubator_predictionio_torch.tools import console  # noqa: E402
from incubator_predictionio_torch.workflow import checkpoint as ckpt_mod  # noqa: E402
from incubator_predictionio_torch.workflow.checkpoint import (  # noqa: E402
    CheckpointHook, CheckpointIncompatibleError,
)
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402
from incubator_predictionio_torch.workflow.persist import load_models  # noqa: E402
from incubator_predictionio_torch.workflow.workflow_params import WorkflowParams  # noqa: E402

TOL = 2e-4
ROOT = Path(__file__).resolve().parents[1]


def _toy_ratings(n_users=40, n_items=25, density=0.4, seed=2):
    rng = np.random.default_rng(seed)
    mask = rng.random((n_users, n_items)) < density
    u, i = np.nonzero(mask)
    r = rng.uniform(1, 5, len(u)).astype(np.float32)
    return u.astype(np.int32), i.astype(np.int32), r


def _params(**kw):
    base = dict(rank=4, num_iterations=6, reg=0.05, block_len=8, seed=11)
    base.update(kw)
    return base


def _port(u, i, r, hook=None, resume=False, **kw):
    return port_als.train_als(u, i, r, 40, 25,
                              port_als.ALSParams(**_params(**kw)),
                              device="cpu", checkpoint_hook=hook,
                              resume=resume)


def _ref(u, i, r, hook=None, **kw):
    mesh = mesh_from_devices(devices=jax.devices()[:1])
    return ref_als.train_als(u, i, r, 40, 25, ref_als.ALSParams(**_params(**kw)),
                             mesh=mesh, checkpoint_hook=hook)


def _assert_equal(a, b):
    np.testing.assert_array_equal(a.user_factors, b.user_factors)
    np.testing.assert_array_equal(a.item_factors, b.item_factors)


def test_hook_save_restore_roundtrip(tmp_path):
    hook = CheckpointHook(str(tmp_path / "ckpt"), every_n=2)
    tree = {"user_factors": np.arange(12, dtype=np.float32).reshape(3, 4),
            "item_factors": np.ones((2, 4), np.float32)}
    assert hook.latest_step() is None
    assert not hook.maybe_save(1, tree)   # off-cadence step: skipped
    assert hook.maybe_save(2, tree)
    hook.save(4, {k: torch.from_numpy(v * 2) for k, v in tree.items()})
    assert hook.latest_step() == 4
    step, restored = hook.restore()
    assert step == 4
    np.testing.assert_array_equal(restored["user_factors"],
                                  tree["user_factors"] * 2)
    step2, restored2 = hook.restore(2)
    assert step2 == 2
    np.testing.assert_array_equal(restored2["user_factors"],
                                  tree["user_factors"])
    # written atomically: nothing but the step files is left behind
    assert sorted(os.listdir(hook.directory)) == ["2.npz", "4.npz"]
    hook.close()


def test_hook_max_to_keep_and_disabled_saving(tmp_path):
    hook = CheckpointHook(str(tmp_path / "ckpt"), every_n=1, max_to_keep=2)
    for s in (1, 2, 3):
        hook.save(s, {"x": np.full(3, s, np.float32)})
    hook.close()
    hook2 = CheckpointHook(str(tmp_path / "ckpt"))  # every_n 0: restore only
    assert not hook2.enabled and not hook2.maybe_save(4, {"x": np.zeros(1)})
    assert hook2.latest_step() == 3
    with pytest.raises(FileNotFoundError):
        hook2.restore(1)  # pruned by max_to_keep
    hook2.delete_all()
    assert hook2.latest_step() is None and not os.path.exists(hook2.directory)


def test_als_checkpointed_matches_single_shot(tmp_path):
    """Chunked loop == one unchunked loop, bit for bit on the CPU, and
    within 2e-4 of the reference's train_als."""
    u, i, r = _toy_ratings()
    plain = _port(u, i, r)
    hook = CheckpointHook(str(tmp_path / "ck"), every_n=2, max_to_keep=5)
    chunked = _port(u, i, r, hook=hook)
    _assert_equal(chunked, plain)
    # boundaries 2 and 4 snapshotted; 6 (completion) not
    assert hook.latest_step() == 4
    ref = _ref(u, i, r)
    np.testing.assert_allclose(chunked.user_factors, ref.user_factors,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(chunked.item_factors, ref.item_factors,
                               rtol=TOL, atol=TOL)


def test_als_resume_after_crash_matches_uninterrupted(tmp_path):
    """Interrupted after 4 of 6 iterations (snapshot at 2), resumed → the
    uninterrupted run, bit for bit."""
    u, i, r = _toy_ratings(seed=5)
    full = _port(u, i, r)
    hook = CheckpointHook(str(tmp_path / "ck"), every_n=2, max_to_keep=5)
    _port(u, i, r, hook=hook, num_iterations=4)
    assert hook.latest_step() == 2
    resumed = _port(u, i, r, hook=hook, resume=True)
    _assert_equal(resumed, full)
    # a resume with snapshots off (every_n 0) restores all the same
    quiet = _port(u, i, r, hook=CheckpointHook(hook.directory), resume=True)
    _assert_equal(quiet, full)


def test_resume_runs_only_the_remaining_iterations(tmp_path, monkeypatch):
    u, i, r = _toy_ratings(seed=5)
    hook = CheckpointHook(str(tmp_path / "ck"), every_n=2)
    _port(u, i, r, hook=hook, num_iterations=4)
    done = []
    real = port_als.ALSTrainer.iterate
    monkeypatch.setattr(port_als.ALSTrainer, "iterate",
                        lambda self, n: (done.append(n), real(self, n)))
    _port(u, i, r, hook=hook, resume=True)
    assert sum(done) == 4  # 6 requested, 2 restored


def test_als_resume_rejects_changed_data(tmp_path):
    u, i, r = _toy_ratings(seed=5)
    hook = CheckpointHook(str(tmp_path / "ck"), every_n=1, max_to_keep=3)
    _port(u, i, r, hook=hook, num_iterations=3)
    assert hook.latest_step() == 2
    with pytest.raises(CheckpointIncompatibleError, match="do not match"):
        # rank changed since the interrupted run → snapshot is unusable
        _port(u, i, r, hook=hook, resume=True, rank=6, num_iterations=5)
    # same shapes, different rating VALUES → fingerprint catches it
    r2 = r.copy()
    r2[0] += 1.0
    with pytest.raises(CheckpointIncompatibleError, match="fingerprint"):
        _port(u, i, r2, hook=hook, resume=True, num_iterations=5)
    # fewer iterations than the snapshot's step
    with pytest.raises(CheckpointIncompatibleError,
                       match="latest checkpoint is at iteration 2"):
        _port(u, i, r, hook=hook, resume=True, num_iterations=2)
    assert issubclass(CheckpointIncompatibleError, ValueError)


def test_fingerprint_is_the_references(tmp_path):
    """The fingerprint in the port's snapshot equals the one the reference
    writes for the same triple on one device (same slot plan, same crc32
    chain seeded with _LAYOUT_TAG)."""
    u, i, r = _toy_ratings(seed=3)
    assert port_als._LAYOUT_TAG == ref_als._LAYOUT_TAG
    ref_hook = ref_ckpt.CheckpointHook(str(tmp_path / "ref"), every_n=1)
    _ref(u, i, r, hook=ref_hook, num_iterations=2)
    _, ref_tree = ref_hook.restore(1)
    ref_hook.close()
    hook = CheckpointHook(str(tmp_path / "port"), every_n=1)
    _port(u, i, r, hook=hook, num_iterations=2)
    _, tree = hook.restore(1)
    assert tree["fingerprint"].dtype == np.int64
    assert int(tree["fingerprint"]) == int(np.asarray(ref_tree["fingerprint"]))
    # the snapshot holds slot-order factors, without the sentinel row
    np.testing.assert_allclose(tree["user_factors"],
                               np.asarray(ref_tree["user_factors"]),
                               rtol=TOL, atol=TOL)
    assert tree["item_factors"].shape == np.asarray(
        ref_tree["item_factors"]).shape


def _wire_events(n_users=30, n_items=20, n=400, seed=0):
    rng = np.random.default_rng(seed)
    return [{"event": "rate", "entityType": "user",
             "entityId": str(int(rng.integers(n_users))),
             "targetEntityType": "item",
             "targetEntityId": str(int(rng.integers(n_items))),
             "properties": {"rating": float(rng.uniform(1, 5))},
             "eventTime": f"2024-01-01T00:{j // 60:02d}:{j % 60:02d}.000Z"}
            for j in range(n)]


ALGO = {"rank": 4, "numIterations": 6, "lambda": 0.05, "seed": 11,
        "block_len": 8}


def test_multi_algorithm_checkpoint_namespacing(tmp_path, monkeypatch):
    """Two algorithms in one engine snapshot into separate subdirectories,
    and the root hook is back on the context afterwards, also when an
    algorithm fails."""
    engine = Engine(data_source_class=port_rec.RecommendationDataSource,
                    algorithm_class_map={"a1": port_rec.ALSAlgorithm,
                                         "a2": port_rec.ALSAlgorithm})
    ep = EngineParams(algorithm_params_list=[("a1", ALGO), ("a2", ALGO)])
    saved_dirs = []
    real_save = ckpt_mod.CheckpointHook.save

    def spy_save(self, step, tree):
        saved_dirs.append(self.directory)
        real_save(self, step, tree)

    monkeypatch.setattr(ckpt_mod.CheckpointHook, "save", spy_save)
    root = CheckpointHook(str(tmp_path / "ck"), every_n=2)
    ctx = WorkflowContext(events=_wire_events(), device="cpu",
                          checkpoint_hook=root)
    models = engine.train(ctx, ep, WorkflowParams(checkpoint_every=2))
    assert len(models) == 2 and ctx.checkpoint_hook is root
    assert {os.path.basename(d) for d in saved_dirs} == {"algo_0_a1",
                                                         "algo_1_a2"}
    assert all(os.path.dirname(d) == root.directory for d in saved_dirs)

    def crashing_save(self, step, tree):
        raise RuntimeError("injected crash")

    monkeypatch.setattr(ckpt_mod.CheckpointHook, "save", crashing_save)
    with pytest.raises(RuntimeError, match="injected"):
        engine.train(ctx, ep, WorkflowParams(checkpoint_every=2))
    assert ctx.checkpoint_hook is root


_CRASHING_TRAIN = r"""
import sys
from incubator_predictionio_torch.tools import console
from incubator_predictionio_torch.workflow import checkpoint

real = checkpoint.CheckpointHook.save

def crashing_save(self, step, tree):
    real(self, step, tree)
    if step == 2:
        raise RuntimeError("injected mid-train crash")

checkpoint.CheckpointHook.save = crashing_save
sys.exit(console.main(sys.argv[1:]))
"""


def _console(args, crash=False):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = ([sys.executable, "-c", _CRASHING_TRAIN] if crash else
           [sys.executable, "-m", "incubator_predictionio_torch.tools.console"])
    return subprocess.run(cmd + args, capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=300)


def test_console_checkpoint_resume_lifecycle(tmp_path):
    """console train --checkpoint-every 1 crashes after the step-2
    snapshot and keeps its snapshots; --resume completes from them,
    deletes them and persists the uninterrupted model bit for bit; after
    the events change, --resume discards the stale snapshots and trains
    from scratch."""
    events = _wire_events()
    ev_path = tmp_path / "events.jsonl"
    ev_path.write_text("\n".join(json.dumps(e) for e in events) + "\n")
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps({"algorithms": [
        {"name": "als", "params": ALGO}]}))
    model = tmp_path / "model.npz"
    snapshots = Path(console.checkpoint_dir(str(model)))
    base = ["train", "--engine-json", str(engine_json), "--events",
            str(ev_path), "--model-out", str(model), "--device", "cpu"]

    out = _console(base + ["--checkpoint-every", "1"], crash=True)
    assert out.returncode != 0 and "injected" in out.stderr
    assert not model.exists()
    assert sorted(os.listdir(snapshots / "algo_0_als")) == ["1.npz", "2.npz"]

    out = _console(base + ["--resume"])
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["trained"] == \
        str(model)
    assert not snapshots.exists()
    _, stored = load_models(model)
    engine = port_rec.RecommendationEngine()()
    direct = engine.train(WorkflowContext(events=events, device="cpu"),
                          EngineParams.from_json({"algorithms": [
                              {"name": "als", "params": ALGO}]}))[0]
    np.testing.assert_array_equal(stored[0]["user_factors"],
                                  direct.factors.user_factors)
    np.testing.assert_array_equal(stored[0]["item_factors"],
                                  direct.factors.item_factors)

    # a stale snapshot from other data: --resume falls back to scratch
    _console(base + ["--checkpoint-every", "1"], crash=True)
    assert snapshots.exists()
    changed = events + [dict(events[0], properties={"rating": 5.0},
                             eventTime="2024-01-01T01:00:00.000Z")]
    ev_path.write_text("\n".join(json.dumps(e) for e in changed) + "\n")
    out = _console(base + ["--resume"])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "discarding stale checkpoints" in out.stderr
    assert not snapshots.exists()


def test_console_stop_flags_persist_nothing(tmp_path):
    ev_path = tmp_path / "events.jsonl"
    ev_path.write_text("\n".join(json.dumps(e) for e in _wire_events()))
    model = tmp_path / "model.npz"
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps({"algorithms": [
        {"name": "als", "params": ALGO}]}))
    for flag in ("--stop-after-read", "--stop-after-prepare"):
        assert console.main(["train", "--engine-json", str(engine_json),
                             "--events", str(ev_path), "--model-out",
                             str(model), "--device", "cpu", flag]) == 0
        assert not model.exists()
