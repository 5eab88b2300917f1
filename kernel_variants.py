"""Time design variants of the ``stripes`` CUDA kernel against each other.

  python3 kernel_variants.py [--seed 0]

Each variant is ``src/repro_torch/kernels/csrc/stripes.cu`` with one design
choice edited out or changed, built with the same nvcc flags into
``build/variants/`` and called through the same C entry point as the
wrapper, on ``chip_smoke.py``'s Algorithm 5 tokens (2**24 ids of the Zipf
corpus at V 4096, window 4) and on 2**24 uniform ids.  Every variant's
table must equal the plain version's.  Prints one line per (tokens,
variant) with two CUDA-event timings (ms per call, 5 calls each), and the
card's name and power limit.  Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "src"))

# the fold's cold-pair atomic, and the same atomic aggregated across the
# warp with __match_any_sync on the cell
_COLD = """} else if (pair) {
                    atomicAdd(out + (long long)min(a, b) * vocab + max(a, b), add);
                }"""
_COLD_MATCH = """}
                const long long cell = (pair && !hot_pair)
                    ? (long long)min(a, b) * vocab + max(a, b) : -1LL;
                const unsigned peers = __match_any_sync(0xffffffffu, cell);
                if (cell >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
                    atomicAdd(out + cell, add * __popc(peers));
                }"""
_HOT_MAX = "constexpr int kHotMax = 128;"
VARIANTS = {
    "as built": [],
    "cold pairs aggregated with __match_any_sync": [(_COLD, _COLD_MATCH)],
    "hot set of 64": [(_HOT_MAX, "constexpr int kHotMax = 64;")],
    "no hot set": [(_HOT_MAX, "constexpr int kHotMax = 0;")],
}


def variant_libraries(build_dir):
    from repro_torch.kernels._build import CudaLibrary, build_all
    from repro_torch.kernels.stripes import LIBRARY

    text = LIBRARY.source.read_text()
    build_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: edit not found once")
            src = src.replace(old, new)
        path = build_dir / f"stripes_variant{i}.cu"
        path.write_text(src)
        lib = CudaLibrary(f"stripes_variant{i}", LIBRARY.functions)
        lib.source = path
        libs[name] = lib
    build_all(list(libs.values()))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from pathlib import Path

    import chip_smoke
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.stripes import _HOT_MAX, stripe_counts_plain

    libs = variant_libraries(Path(_HERE) / "build" / "variants")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    vocab, window = 4096, 4
    streams = {
        "zipf": chip_smoke.corpus_tokens(vocab, 1 << 24, args.seed + 2, dev),
        "uniform": torch.randint(0, vocab, (1 << 24,), generator=gen,
                                 device=dev, dtype=torch.int32)}
    for tokens_name, toks in streams.items():
        want = stripe_counts_plain(toks, vocab, window)
        for name, lib in libs.items():
            launch = lib.load().stripes_launch

            def call():
                out = torch.zeros((vocab, vocab), dtype=torch.int32,
                                  device=dev)
                hot = torch.empty((_HOT_MAX + 1,), dtype=torch.int32,
                                  device=dev)
                err = launch(toks.data_ptr(), out.data_ptr(), hot.data_ptr(),
                             toks.numel(), vocab, window, sm_count(dev),
                             torch._C._cuda_getCurrentRawStream(dev.index))
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")
                return out

            if not torch.equal(call(), want):
                raise RuntimeError(f"variant {name!r} != the plain version")
            print(f"stripes variant [{name}] {tokens_name} V={vocab} "
                  f"W={window} N={toks.numel()}: exact, ms="
                  f"{chip_smoke.cuda_ms(call, 5)} / "
                  f"{chip_smoke.cuda_ms(call, 5)}", flush=True)
    print(f"card: {chip_smoke.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
