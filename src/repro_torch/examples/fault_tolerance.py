"""Fault-tolerance walkthrough through the port, the twin of
``examples/fault_tolerance.py``: kill a training run mid-step, resume from
the atomic checkpoint and match the final loss of an uninterrupted run;
re-plan the mesh when ranks are lost; then the same kill and resume
through the data-parallel driver on two ranks, with compressed gradients
(a restore zeroes the error-feedback state).

Reduced deepseek-7b, batch 2 x 32 tokens (4 x 32 over the two ranks).
Without ``--device cpu`` it runs on the card, the two ranks sharing it.

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerance \\
        --device cpu
"""
import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.distributed import fault_tolerance as ft
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.train import TrainerConfig, train


def _tc(ckpt_dir: str, device: str, **kw) -> TrainerConfig:
    base = dict(arch="deepseek-7b", reduced=True, steps=24,
                ckpt_dir=ckpt_dir, ckpt_every=8, batch_override=2,
                seq_override=32, lr=3e-3, device=device)
    return TrainerConfig(**{**base, **kw})


def dp_kill_and_resume(ckpt_dir: str, device: str) -> dict:
    """In each of two ranks: a compressed data-parallel run killed at step
    13, then resumed from its step-8 checkpoint."""
    tc = _tc(ckpt_dir, device, batch_override=4, data_parallel=True,
             compress=True, mesh_devices=2, log_every=100)
    try:
        train(tc, failure_hook=ft.failure_injector({13}))
    except ft.SimulatedFailure:
        pass
    resumed = train(tc)
    return {"first": resumed[0]["step"], "last": resumed[-1]["step"],
            "loss": resumed[-1]["loss"]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    workdir = tempfile.mkdtemp(prefix="repro_torch_ft_")

    print("=== 1. uninterrupted run (24 steps) ===")
    full = train(_tc(workdir + "/a", args.device))
    print(f"final loss: {full[-1]['loss']:.5f}")

    print("\n=== 2. run killed at step 13 (injected failure) ===")
    try:
        train(_tc(workdir + "/b", args.device),
              failure_hook=ft.failure_injector({13}))
    except ft.SimulatedFailure as e:
        print(f"crashed as injected: {e}")

    print("\n=== 3. restart: auto-resumes from the step-8 checkpoint ===")
    resumed = train(_tc(workdir + "/b", args.device))
    print(f"resumed at step {resumed[0]['step']}, "
          f"final loss: {resumed[-1]['loss']:.5f}")
    match = np.isclose(resumed[-1]["loss"], full[-1]["loss"], rtol=1e-6)
    print(f"matches uninterrupted run: {match}")
    assert match

    print("\n=== 4. elastic re-meshing after losing ranks ===")
    for survivors in (256, 244, 192, 100):
        plan = ft.plan_mesh(survivors, model_parallel=16)
        idle = survivors - plan.n_devices
        print(f"  {survivors:4d} ranks survive -> mesh {plan.shape} "
              f"({plan.n_devices} used, {idle} idle)")

    print("\n=== 5. kill and resume through the data-parallel driver ===")
    got = mesh_mod.spawn(dp_kill_and_resume, 2, workdir + "/c", args.device,
                         device=args.device)
    print(f"2 ranks, compressed gradients: resumed at step {got['first']}, "
          f"ran to step {got['last']}, final loss {got['loss']:.5f}")
    assert (got["first"], got["last"]) == (9, 23)

    shutil.rmtree(workdir, ignore_errors=True)
    print("\nall good.")


if __name__ == "__main__":
    main()
