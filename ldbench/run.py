"""Run one cell of the port's benchmark once, on the CUDA card.

    python3 ldbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--control]

Prints one JSON object as the last line of standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`, each number the comparison made beside its limit; the
same numbers are the last lines of standard error.  `--control` also
judges the control (the plain reference at the lower precision its traffic
names) on the same frames and prints its numbers to standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with a nonzero code and prints no result; so it does where the process
holds a module of JAX or of the JAX package once everything that decides
the result has run, the comparison with the reference included.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHES = os.path.join(ROOT, 'build', 'ldbench')
# every build and kernel cache at a fixed path inside the checkout
os.environ['TRITON_CACHE_DIR'] = os.path.join(CACHES, 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(CACHES, 'torch_extensions')
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    p.add_argument('--control', action='store_true',
                   help='also judge the control on the same frames')
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        from ldbench import harness
        cell = harness.resolve(args.workload)
        import torch
        if not torch.cuda.is_available():
            print('ldbench: no CUDA device; the benchmark runs on the card '
                  'only', file=sys.stderr)
            return 2
        if torch.cuda.device_count() < int(cell['chips']):
            print(f'ldbench: {args.workload} needs {cell["chips"]} cards, '
                  f'{torch.cuda.device_count()} found', file=sys.stderr)
            return 2
        result = harness.run(cell, args.seed, args.seconds,
                             bool(args.trace), 'cuda:0', T_START,
                             control=args.control)
    except Exception:
        traceback.print_exc()
        return 1
    for k in ('_card', '_source', '_window', '_cycles', '_trace',
              '_sampled_frames', '_extras', '_control', '_reasons'):
        if k in result:
            print(f'ldbench {k[1:]}: {json.dumps(result.pop(k))}',
                  file=sys.stderr)
    for name, c in result['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    loaded = harness.jax_loaded()
    if loaded:
        print('ldbench: the run loaded ' + ', '.join(loaded)
              + '; no result', file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
