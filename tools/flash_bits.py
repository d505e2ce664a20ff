#!/usr/bin/env python3
"""Compare the flash attention kernel of two source trees bit for bit, on
one GPU.

    python3 tools/flash_bits.py TREE_A TREE_B

Each TREE (a checkout of this repository: ``TREE/src/repro_torch``) runs
in a process of its own, builds its kernels from its own sources and
calls only ``flash.flash_attention_fwd``, on the same inputs: q (2, 32,
1000, D) over 8 KV heads, random from a CUDA generator seeded with D, at
D 64, 112 and 128, bf16 (the tensor-core instance) and float32 (the CUDA-core
instance), causal and not.  The outputs go to ``build/flash_bits_*.pt``
beside this repository's ``build/``; the script prints, per case, whether
the two trees' outputs are equal, and exits non-zero unless all are.
"""
import subprocess
import sys
from pathlib import Path

HEAD_DIMS = (64, 112, 128)
BUILD = Path(__file__).resolve().parents[1] / "build"


def dump(tree: str, out: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from repro_torch.kernels.attention import flash
    res = {}
    for d in HEAD_DIMS:
        for dt in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(d)
            q = torch.randn((2, 32, 1000, d), generator=g, device="cuda")
            k = torch.randn((2, 8, 1000, d), generator=g, device="cuda")
            v = torch.randn((2, 8, 1000, d), generator=g, device="cuda")
            for causal in (True, False):
                res[f"D {d} {str(dt)[6:]} causal={causal}"] = \
                    flash.flash_attention_fwd(q.to(dt), k.to(dt), v.to(dt),
                                              causal=causal).cpu()
    torch.save(res, out)


def main() -> int:
    if sys.argv[1] == "--dump":
        dump(sys.argv[2], sys.argv[3])
        return 0
    import torch
    BUILD.mkdir(exist_ok=True)
    outs = []
    for i, tree in enumerate(sys.argv[1:3]):
        out = str(BUILD / f"flash_bits_{i}.pt")
        subprocess.run([sys.executable, __file__, "--dump", tree, out],
                       check=True)
        outs.append(torch.load(out))
    same = {k: bool(torch.equal(outs[0][k], outs[1][k])) for k in outs[0]}
    print(f"[flash bits] {sys.argv[1]} vs {sys.argv[2]}, "
          f"{torch.cuda.get_device_name(0)}: {same}; all equal "
          f"{all(same.values())}")
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
