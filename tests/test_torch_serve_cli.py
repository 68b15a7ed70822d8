"""The port's serve CLI: flag plumbing, the JSONL stdio loop and ``--selftest``.

Both loops run in process on the CPU over a light checkpoint that the
port's train CLI wrote (``--device cpu``).  Flags the port does not carry
yet (``--obs-port``, the exporter's) are refused as unknown.
"""

import io
import json
import sys

import pytest

from r2d2dpg_torch.serve import build_service, main, parse_args
from r2d2dpg_torch.serving import PolicyService, ServiceRouter
from r2d2dpg_torch.train import main as train_main


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve") / "ckpt")
    train_main(["--config", "pendulum_tiny", "--phases", "1", "--device", "cpu",
                "--log-every", "0", "--checkpoint-dir", d, "--checkpoint-light"])
    return d


def test_parse_args_plumbing():
    args = parse_args([
        "--config", "pendulum_tiny", "--checkpoint-dir", "ck",
        "--bucket-sizes", "2,8", "--flush-ms", "1.5", "--max-queue", "7",
        "--max-sessions", "3", "--session-ttl", "9", "--poll-every", "0.5",
        "--device", "cpu",
    ])
    assert args.config == "pendulum_tiny" and args.checkpoint_dir == "ck"
    assert args.bucket_sizes == "2,8" and args.flush_ms == 1.5
    assert (args.max_queue, args.max_sessions) == (7, 3)
    assert (args.session_ttl, args.poll_every) == (9.0, 0.5)
    assert args.serve_workers == 1 and args.device == "cpu"
    with pytest.raises(SystemExit):
        parse_args(["--config", "pendulum_tiny", "--checkpoint-dir", "ck",
                    "--obs-port", "0"])


def test_build_service_plain_or_router(ckpt_dir):
    base = ["--config", "pendulum_tiny", "--checkpoint-dir", ckpt_dir,
            "--bucket-sizes", "1,2", "--device", "cpu"]
    svc, obs_shape = build_service(parse_args(base))
    assert type(svc) is PolicyService and svc.worker_label is None
    assert obs_shape == (3,) and svc.step_rows == 2
    router, _ = build_service(parse_args(base + ["--serve-workers", "2"]))
    assert type(router) is ServiceRouter and router.num_workers == 2
    assert [s.worker_label for s in router.services] == ["0", "1"]


def test_serve_stdio_loop_end_to_end(ckpt_dir, monkeypatch, capsys):
    lines = "\n".join([
        json.dumps({"session": "u1", "obs": [0.1, 0.2, 0.3], "reset": True}),
        json.dumps({"session": "u1", "obs": [0.2, 0.3, 0.4]}),
        json.dumps({"cmd": "health"}),
        json.dumps({"cmd": "end_session", "session": "u1"}),
        "not json",
        json.dumps({"session": "u9", "obs": ["boom"]}),
        json.dumps([1, 2, 3]),
        json.dumps({"cmd": "quit"}),
        json.dumps({"session": "never", "obs": [0, 0, 0]}),
    ]) + "\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    main(["--config", "pendulum_tiny", "--checkpoint-dir", ckpt_dir,
          "--flush-ms", "1", "--device", "cpu"])
    captured = capsys.readouterr()
    assert "backend: cpu" in captured.err
    out = [json.loads(x) for x in captured.out.splitlines()]
    assert len(out) == 7  # nothing after quit
    act1, act2, health, ended, bad_json, bad_obs, bad_type = out
    assert act1["code"] == "ok" and len(act1["action"]) == 1
    assert act1["params_step"] == 5 and act2["code"] == "ok"
    assert health["params_step"] == 5 and health["requests_ok"] == 2
    assert ended == {"code": "ok", "released": True}
    assert bad_json["code"] == "bad_request"
    assert bad_obs["code"] == "bad_request" and "ValueError" in bad_obs["error"]
    assert bad_type["code"] == "bad_request"


@pytest.mark.parametrize("workers", ["1", "2"])
def test_serve_selftest(ckpt_dir, workers, capsys):
    rec = main(["--config", "pendulum_tiny", "--checkpoint-dir", ckpt_dir,
                "--flush-ms", "1", "--selftest", "24", "--device", "cpu",
                "--serve-workers", workers])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec
    assert rec["selftest"] == 24 and rec["codes"] == {"ok": 24}
    assert rec["sessions_active"] == 8 and rec["requests_ok"] == 24
    if workers == "1":
        assert rec["params_step"] == 5
    else:
        assert rec["affinity_violations"] == 0
