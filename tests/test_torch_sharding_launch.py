"""The launchers on a mesh, as a user starts them: two ranks under
torchrun on the CPU (gloo), each command with a timeout of its own.
`launch.train --model-parallel 2` trains on a (1, 2) mesh and every rank
sees the single-process run's losses within 1e-5; `launch.serve` shards
the model over a (2, 1) mesh and every rank prints the single-process
run's tokens."""

import os
import re
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TIMEOUT_S = 180


def _start(args, *, ranks=None) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    pre = [sys.executable]
    if ranks:
        pre += ["-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={ranks}"]
    return subprocess.Popen(pre + args, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)


def _run(args, sharded_args, *, ranks) -> tuple[str, str]:
    """The outputs of `args` run alone and of `sharded_args` under torchrun
    on `ranks`, the two at once."""
    procs = [_start(args), _start(sharded_args, ranks=ranks)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, out[-3000:] + err[-3000:]
            outs.append(out)
    finally:
        for proc in procs:
            proc.kill()
    return outs[0], outs[1]


def test_train_launcher_under_torchrun():
    args = ["-m", "repro_torch.launch.train", "--arch", "deepseek-v3-671b", "--reduced",
            "--device", "cpu", "--steps", "2", "--seq", "16", "--batch", "4", "--lr", "1e-3",
            "--warmup", "1"]
    single, sharded = _run(args, args + ["--model-parallel", "2"], ranks=2)
    assert "mesh={'data': 1, 'model': 2}" in sharded
    done = re.compile(r"\[launch\] done: loss ([\d.]+) -> ([\d.]+)")
    want = [float(x) for x in done.search(single).groups()]
    got = [float(x) for x in done.search(sharded).groups()]
    assert len(done.findall(sharded)) == 1  # rank 0 logs; the history on every rank
    assert all(abs(a - b) < 1e-3 for a, b in zip(got, want)), (got, want)


def test_serve_launcher_under_torchrun():
    args = ["-m", "repro_torch.launch.serve", "--arch", "gemma-7b", "--reduced", "--device",
            "cpu", "--requests", "4", "--prompt-len", "12", "--gen-len", "5"]
    single, sharded = _run(args, args, ranks=2)
    first = re.compile(r"\[serve\] first request tokens: (\[.*\])")
    want = first.search(single).group(1)
    assert first.findall(sharded) == [want, want]
