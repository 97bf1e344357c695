"""Experiment launcher (counterpart of the repo root's `launch.py`): writes
a reproducible launch script and runs it on this host.

    python3 -m lookoncetohear_tpu_torch.launch --launch_config L.json \\
        --exp_config configs/tsh.json --run_dir runs/tsh [--dry_run]

The script clones the repository at the current commit into
`work_dir/<run name>`, unpacks the dataset tarballs, copies local files,
and runs the port's trainer under torchrun, one process per card with
`LOOKONCE_DIST=auto` (`parallel/distributed.py`), in a bounded retry
loop: each attempt passes `--resume`, so a restart after a failure or a
preemption costs at most one epoch. `--dry_run` writes the script and
does not launch it; without it the repository must be clean and pushed.

Launch config JSON fields: work_dir, nproc_per_node (default 1),
venv_activate (optional), dataset_paths [], local_files [], env {}
(extra environment variables), max_restarts (default 100).

The JAX launcher's dispatch to the workers of a TPU pod (`gcloud ...
tpu-vm ssh --worker=all`, `tpu_name`, `zone`, `project`) has no
counterpart: the script runs on the host it is launched from.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess

from lookoncetohear_tpu_torch import utils


def _git(args, cwd) -> str:
    return subprocess.run(["git"] + args, cwd=cwd, check=True,
                          capture_output=True, text=True).stdout.strip()


def create_launch_script(cfg) -> str:
    """Write run_dir/run.sh for the launch config `cfg` (a `Params` with
    run_dir, exp_name, commit_hash and git_repo set); returns its path."""
    path = os.path.join(cfg.run_dir, "run.sh")
    working_dir = os.path.join(cfg.work_dir, cfg.exp_name)
    lines = [
        "#!/bin/bash",
        "set -x",
        "export PYTHONFAULTHANDLER=1",
        # every torchrun process joins the process group from torchrun's
        # RANK / WORLD_SIZE / MASTER_ADDR
        "export LOOKONCE_DIST=auto",
    ]
    for k, v in getattr(cfg, "env", {}).items():
        lines.append(f"export {k}={v}")
    if getattr(cfg, "venv_activate", None):
        lines.append(f". {cfg.venv_activate}")
    lines += [
        f"if [ -d {working_dir} ]; then chmod -R +w {working_dir};"
        f" rm -rf {working_dir}; fi",
        f"git clone {cfg.git_repo} {working_dir}",
        f"cd {working_dir}",
        f"git checkout {cfg.commit_hash}",
    ]
    for p in getattr(cfg, "dataset_paths", []):
        lines.append(f"tar -xf {p} -C {working_dir}/data")
    for lf in getattr(cfg, "local_files", []):
        if os.path.exists(lf):
            dest = os.path.dirname(os.path.join(working_dir, lf))
            lines += [f"mkdir -p {dest}",
                      f"cp -R {os.path.abspath(lf)} {dest}"]
        else:
            print(f"Warning: local file {lf} does not exist.")
    config = os.path.join(cfg.run_dir, "config.json")
    nproc = int(getattr(cfg, "nproc_per_node", 1))
    train = (f"torchrun --nproc_per_node {nproc} -m "
             f"lookoncetohear_tpu_torch.trainer --config {config} "
             f"--run_dir {cfg.run_dir} --resume")
    max_restarts = getattr(cfg, "max_restarts", 100)
    lines += [
        f"for i in $(seq 1 {max_restarts}); do",
        f"  {train} >> {cfg.run_dir}/out.log 2>&1 && break",
        "  echo \"trainer exited nonzero; retrying ($i)\"",
        "  sleep 30",
        "done",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.chmod(path, 0o755)
    return path


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--launch_config", required=True,
                   help="launch configuration JSON")
    p.add_argument("--exp_config", required=True,
                   help="experiment configuration JSON")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)

    repo_dir = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
    if not args.dry_run:
        if _git(["status", "--porcelain"], repo_dir):
            raise RuntimeError("There are uncommitted changes in the "
                               "repository.")
        if _git(["rev-list", "--count", "@{u}..HEAD"], repo_dir) != "0":
            raise RuntimeError("There are unpushed commits.")
    cfg = utils.Params(args.launch_config)
    os.makedirs(args.run_dir)
    cfg.run_dir = os.path.abspath(args.run_dir)
    cfg.exp_name = os.path.basename(cfg.run_dir)
    shutil.copy(args.exp_config, os.path.join(cfg.run_dir, "config.json"))
    cfg.commit_hash = _git(["rev-parse", "HEAD"], repo_dir)
    cfg.git_repo = _git(["remote", "get-url", "origin"], repo_dir) \
        if _git(["remote"], repo_dir) else repo_dir
    script = create_launch_script(cfg)
    print(f"Wrote launch script to {script}")
    if not args.dry_run:
        subprocess.Popen(["bash", script])
        print(f"Launched experiment {cfg.exp_name}")
    return script


if __name__ == "__main__":
    main()
