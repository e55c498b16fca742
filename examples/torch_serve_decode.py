"""Serve a reduced model with batched requests on the PyTorch port:
prefill + greedy decode. Twin of examples/serve_decode.py, with the same
printout.

Serves on `--device`: the card unless `--device cpu` is given (cuda raises
when no GPU is visible). On the card every prefill layer's attention is
the flash kernel and every decode layer's the decode kernel; mamba2, the
default, has no attention.

  PYTHONPATH=src python examples/torch_serve_decode.py --arch mamba2-370m
  PYTHONPATH=src python examples/torch_serve_decode.py --device cpu \\
      --arch whisper-tiny
"""

import argparse

from repro_torch.core.device import DEVICES
from repro_torch.launch.serve import serve


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=list(DEVICES),
                    help="run on the card (default) or the CPU")
    args = ap.parse_args()
    seqs, t_prefill, t_decode = serve(
        args.arch, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
        device=args.device)
    print(f"[example] {args.arch}: generated {seqs.shape[0]}x{seqs.shape[1]} "
          f"tokens; prefill {t_prefill:.2f}s, decode {t_decode:.2f}s")
    print("[example] first sequence:", seqs[0, :20].cpu().tolist())


if __name__ == "__main__":
    main()
