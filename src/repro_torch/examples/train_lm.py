"""End-to-end LM training through the port, the twin of
``examples/train_lm.py``.

Without flags it trains deepseek-7b on the card at its published widths
with the depth cut to fit one 80 GB card (8 layers, bf16, one sequence of
4096 tokens, lr 3e-4 constant); ``--arch mamba2-2.7b`` trains all 64
layers, each block recomputed in the backward (``remat="full"``);
``--arch granite-moe-3b-a800m`` trains 8 of its 32 MoE layers.  ``--device cpu`` runs the reduced config
(a CPU-sized deepseek-family model, batch 4 x 64, lr 3e-3) on the kernels'
plain versions.  Checkpoints go to ``--ckpt-dir`` every 50 steps (on the
CPU, a fresh temporary directory by default; on the card none by default,
for one checkpoint of the 8-layer model with its AdamW moments is about
25 GB); re-run with the same ``--ckpt-dir`` to resume.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
        --steps 6
"""
import argparse
import tempfile

from repro_torch.launch.train import TrainerConfig, train
from repro_torch.optim import adamw

#: What fits one 80 GB card with AdamW's float32 moments, per arch: the
#: depth cut and the remat policy (mamba2-2.7b's 2.7 G parameters need
#: about 32 GB before activations).
CARD = {"deepseek-7b": dict(config_overrides=(("n_layers", 8),)),
        "mamba2-2.7b": dict(remat="full"),
        "granite-moe-3b-a800m": dict(config_overrides=(("n_layers", 8),))}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--mode", default="brainslug",
                    choices=["brainslug", "xla", "barrier"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: on the CPU a fresh "
                         "temporary one, so nothing resumes; on the card "
                         "none)")
    args = ap.parse_args()
    ckpt_dir = args.ckpt_dir
    if not ckpt_dir and args.device == "cpu":
        ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_")

    kw = {}
    if args.device == "cpu":
        tc = TrainerConfig(arch=args.arch, reduced=True, steps=args.steps,
                           mode=args.mode, ckpt_dir=ckpt_dir, ckpt_every=50,
                           batch_override=4, seq_override=64, lr=3e-3,
                           device="cpu")
    else:
        tc = TrainerConfig(arch=args.arch, reduced=False, steps=args.steps,
                           mode=args.mode, ckpt_dir=ckpt_dir, ckpt_every=50,
                           batch_override=1, seq_override=4096,
                           device=args.device, log_every=1,
                           **CARD.get(args.arch, {}))
        kw["opt_cfg"] = adamw.AdamWConfig(lr=3e-4)

    history = train(tc, **kw)
    if history:
        print(f"\nloss: {history[0]['loss']:.4f} -> "
              f"{history[-1]['loss']:.4f} over {len(history)} steps")
        if ckpt_dir:
            print(f"checkpoints under {ckpt_dir}; re-run with --ckpt-dir "
                  f"{ckpt_dir} to resume.")
    else:
        print("nothing to do (already trained to --steps; bump --steps or "
              "clear the checkpoint dir)")


if __name__ == "__main__":
    main()
