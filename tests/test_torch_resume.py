"""The port's launchers with checkpoints, resume and chaos, called
in-process on the CPU: the counterparts of tests/test_cli_e2e.py's resume
(dlrm-m2) and DLRM-serving chaos runs, held to more than the reference's
own tests hold: a resumed run and a chaos run give the losses and the
table of the uninterrupted, fault-free run bit for bit (the same step
recomputed on the same bits). Smoke dlrm-m2 (and dlrm-m1 for serving),
batch 16.
"""
import signal

import numpy as np
import pytest
import torch

from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.train import steps

BASE = ["--arch", "dlrm-m2", "--smoke", "--batch", "16", "--device", "cpu"]


def _train(tmp_path, *extra):
    return train_cli.main(BASE + ["--ckpt-dir", str(tmp_path), *extra])


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """12 uninterrupted steps with no checkpoint."""
    return _train(tmp_path_factory.mktemp("straight"), "--steps", "12",
                  "--log-every", "100")


def test_train_cli_dlrm_resume(tmp_path, capsys, straight):
    first = _train(tmp_path, "--steps", "8", "--ckpt-every", "4")
    out = capsys.readouterr().out
    assert "done at step 8; loss " in out and "stragglers flagged: " in out
    assert sorted(p.name for p in (tmp_path / "dlrm-m2").iterdir()) == [
        "LATEST", "step_000000004", "step_000000008"]
    run = _train(tmp_path, "--steps", "12", "--resume", "--ckpt-every", "4")
    out = capsys.readouterr().out
    assert "resumed from step 8" in out and "done at step 12" in out
    assert run.start_step == 8 and set(run.times) == {
        "step_s", "restore_s", "save_snapshot_s", "save_wait_s"}
    assert len(run.times["step_s"]) == 4
    assert first.losses + run.losses == straight.losses
    assert torch.equal(run.params["emb"]["mega"],
                       straight.params["emb"]["mega"])
    assert torch.equal(run.state["accum"], straight.state["accum"])


def test_resume_from_a_torn_newest_step_continues_the_older_one(tmp_path,
                                                                 capsys,
                                                                 straight):
    """The newest checkpoint fails its CRC: the run resumes from the step
    that loaded, with the pipeline at that step (the reference's launcher
    would count from the newest step and restart the batches at 0)."""
    _train(tmp_path, "--steps", "8", "--ckpt-every", "4")
    leaf = sorted((tmp_path / "dlrm-m2" / "step_000000008")
                  .glob("leaf_*.npy"))[0]
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    run = _train(tmp_path, "--steps", "12", "--resume", "--ckpt-every", "50")
    assert "resumed from step 4" in capsys.readouterr().out
    assert run.losses == straight.losses[4:]


def test_resume_without_a_checkpoint_starts_at_step_0(tmp_path, straight):
    run = _train(tmp_path, "--steps", "12", "--resume")
    assert run.start_step == 0 and run.losses == straight.losses


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_train_cli_chaos_is_bit_equal_to_the_fault_free_run(tmp_path,
                                                            capsys, seed):
    args = ["--steps", "16", "--ckpt-every", "2", "--log-every", "100"]
    clean = _train(tmp_path / "clean", *args)
    capsys.readouterr()
    run = _train(tmp_path / "chaos", *args, "--chaos", "--chaos-seed",
                 str(seed))
    out = capsys.readouterr().out
    assert out.startswith("chaos schedule: ")
    fired = next(ln for ln in out.splitlines()
                 if ln.startswith("chaos: fired "))
    assert fired != "chaos: fired nothing"
    assert "chaos done at step 16: " in out
    assert run.losses == clean.losses
    assert torch.equal(run.params["emb"]["mega"], clean.params["emb"]["mega"])
    assert torch.equal(run.state["accum"], clean.state["accum"])


def test_launcher_puts_back_the_sigterm_handler(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    _train(tmp_path, "--steps", "2")
    _train(tmp_path, "--steps", "4", "--chaos", "--ckpt-every", "2")
    assert signal.getsignal(signal.SIGTERM) is before


def test_sparse_apply_flag_selects_the_update(tmp_path, monkeypatch):
    calls = []

    def spy(name, fn):
        def call(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return call

    monkeypatch.setattr(steps, "dense_sparse_update",
                        spy("dense", steps.dense_sparse_update))
    monkeypatch.setattr(steps.ops, "fused_sparse_backward",
                        spy("sparse", steps.ops.fused_sparse_backward))
    dense = _train(tmp_path, "--steps", "4")
    assert calls == ["dense"] * 4
    sparse = _train(tmp_path, "--steps", "4", "--sparse-apply", "sparse")
    assert calls == ["dense"] * 4 + ["sparse"] * 4
    np.testing.assert_allclose(dense.losses, sparse.losses, rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(SystemExit):
        _train(tmp_path, "--steps", "1", "--sparse-apply", "rows")


def test_dense_buffer_that_does_not_fit_names_the_sparse_flag(monkeypatch):
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (8 << 30,
                                                               80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 3 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 1 << 30)
    train_cli.check_dense_fits(1 << 20, 64, cuda)        # 0.27 GB + headroom
    with pytest.raises(RuntimeError, match="--sparse-apply sparse"):
        train_cli.check_dense_fits(94_900_001, 64, cuda)  # dlrm-m2's 24.3 GB


def _serve_summary(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("serve[dlrm]:"))
    return dict(part.split("=", 1) for part in line.split()[1:])


def test_serve_cli_dlrm_chaos(capsys):
    serve_cli.main(["--arch", "dlrm-m1", "--smoke", "--requests", "12",
                    "--batch", "2", "--max-batch", "8", "--burst", "3",
                    "--chaos", "--chaos-seed", "13", "--device", "cpu"])
    out = capsys.readouterr().out
    kv = _serve_summary(out)
    assert int(kv["served"]) + int(kv["shed"]) == 12
    assert 0.0 <= float(kv["degraded_fraction"]) <= 1.0
    chaos = next(ln for ln in out.splitlines() if "chaos: fired=" in ln)
    assert chaos.strip() != "chaos: fired=[] transitions=[]"
