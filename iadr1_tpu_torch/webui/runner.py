"""Training-run launcher for the web UI (the port's own copy of
iadr1_tpu/webui/runner.py).

Counterpart of llamafactory/webui/runner.py (Runner._launch -> Popen of
`llamafactory-cli train`, :350): form fields become a job config JSON, the
matching CLI module runs as a subprocess, and progress is read back from
the run directory's trainer_log.jsonl (the same file LlamaBoard tails).
The child runs on the card unless the form gives a ``device`` ("cpu"),
which goes to the CLI as ``--device``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# form stage -> (CLI module, config section defaults)
STAGE_CLI = {
    "sft": "iadr1_tpu_torch.cli.train_sft",
    "pt": "iadr1_tpu_torch.cli.train_sft",
    "grpo": "iadr1_tpu_torch.cli.train_grpo",
    "dpo": "iadr1_tpu_torch.cli.train_pref",
    "kto": "iadr1_tpu_torch.cli.train_pref",
    "rm": "iadr1_tpu_torch.cli.train_pref",
    "ppo": "iadr1_tpu_torch.cli.train_pref",
}


def build_job_config(form: dict) -> tuple[str, dict]:
    """Web-form fields -> (CLI module, job config dict).

    Recognized fields: stage, model_name_or_path, dataset, template,
    cutoff_len, learning_rate, max_steps, batch_size, output_dir, plus any
    dotted overrides under "extra" ({"mesh.tp": 2, ...}).  (``device`` is
    the launch's, not the config's: ``Runner.launch`` reads it.)
    """
    stage = form.get("stage", "sft")
    if stage not in STAGE_CLI:
        raise ValueError(f"unknown stage {stage!r}; known: {sorted(STAGE_CLI)}")
    module = STAGE_CLI[stage]
    dataset_key = "dataset_name" if module.endswith(
        ("train_grpo", "train_pref")) else "dataset"
    cfg: dict = {
        "stage": stage,
        "model": {"model_name_or_path": form["model_name_or_path"]},
        "data": {
            dataset_key: form["dataset"],
            "template": form.get("template", "qwen2_vl"),
            "cutoff_len": int(form.get("cutoff_len", 2048)),
        },
        "optim": {
            "learning_rate": float(form.get("learning_rate", 1e-5)),
        },
        "train": {
            "output_dir": form["output_dir"],
            "max_steps": int(form.get("max_steps", 100)),
            "batch_size": int(form.get("batch_size", 8)),
            "logging_steps": int(form.get("logging_steps", 10)),
        },
    }
    if module.endswith("train_sft") and stage == "sft":
        cfg.pop("stage")
    for dotted, value in (form.get("extra") or {}).items():
        node = cfg
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return module, cfg


class Runner:
    """Launch/monitor/abort one training subprocess at a time
    (webui/runner.py Runner semantics)."""

    def __init__(self):
        self.proc: subprocess.Popen | None = None
        self.output_dir: str | None = None
        self.config_path: str | None = None
        self._log = None

    @property
    def running(self) -> bool:
        return self.proc is not None and self._poll() is None

    def _poll(self):
        """The child's return code (None while it runs or before one was
        launched); its log file is closed once it has ended."""
        if self.proc is None:
            return None
        rc = self.proc.poll()
        if rc is not None and self._log is not None:
            self._log.close()
            self._log = None
        return rc

    def launch(self, form: dict, dry_run: bool = False,
               extra_args=()) -> dict:
        """Write the job config and start the CLI on it; the form's
        ``device`` becomes ``--device``, ``extra_args`` are appended to the
        command as they are."""
        if self.running:
            raise RuntimeError("a training run is already in progress")
        module, cfg = build_job_config(form)
        out_dir = cfg["train"]["output_dir"]
        os.makedirs(out_dir, exist_ok=True)
        self.output_dir = out_dir
        self.config_path = os.path.join(out_dir, "webui_job.json")
        with open(self.config_path, "w") as f:
            json.dump(cfg, f, indent=2)
        cmd = [sys.executable, "-m", module, "--config", self.config_path]
        if form.get("device"):
            cmd += ["--device", str(form["device"])]
        cmd += list(extra_args)
        if not dry_run:
            self._log = open(os.path.join(out_dir, "webui_stdout.log"), "w")
            self.proc = subprocess.Popen(
                cmd, stdout=self._log, stderr=subprocess.STDOUT)
        return {"command": cmd, "config": cfg}

    def progress(self) -> dict:
        """Latest trainer_log.jsonl record + process state (the LlamaBoard
        progress-bar feed)."""
        state = "idle"
        returncode = None
        if self.proc is not None:
            rc = self._poll()
            if rc is None:
                state = "running"
            else:
                state, returncode = "finished", rc
        records = []
        if self.output_dir:
            path = os.path.join(self.output_dir, "trainer_log.jsonl")
            if os.path.exists(path):
                with open(path) as f:
                    records = [json.loads(line) for line in f if line.strip()]
        out = {"state": state, "returncode": returncode,
               "n_records": len(records)}
        if records:
            out["latest"] = records[-1]
            out["loss_curve"] = [
                [r.get("current_steps"), r.get("loss")]
                for r in records if r.get("loss") is not None
            ]
        return out

    def abort(self, timeout: float = 10.0) -> bool:
        """SIGTERM the run (webui Runner's abort), escalating to SIGKILL."""
        if not self.running:
            return False
        self.proc.terminate()
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._poll()
        return True
