"""Command-line interface; counterpart of ``vargp_tpu/experiments/cli.py``.

    python -m vargp_tpu_torch <command> [--key=value ...]

Values parse as Python literals; each command is a driver function and
its keywords.  ``--device=cpu|cuda`` picks the device (default: the
card, and no card is an error: nothing moves to the CPU unasked).  The
JAX package's commands that are not ported yet exit non-zero, naming
their ROADMAP item.
"""

import ast
import inspect
import sys

# JAX commands still to port -> the ROADMAP item that ports them
NOT_PORTED = {
    "toy_global": "Queue A item 5 (global SVGP)",
    "s_mnist_global": "Queue A item 5 (global SVGP)",
    "p_mnist_global": "Queue A item 5 (global SVGP)",
    "analyze_toy_global": "Queue A item 5 (global SVGP)",
    "analyze_smnist_global": "Queue A item 5 (global SVGP)",
    "toy_retrain": "Queue A item 5 (retrain)",
    "regression": "Queue A item 5 (the Gaussian likelihood)",
    "compare_methods": "Queue A item 5 (the comparisons and plots)",
    "compare_vcl": "Queue A item 5 (the comparisons and plots)",
    "gen_sweep": "Queue A item 5 (sweep.py)",
    "run_sweep": "Queue A item 5 (sweep.py)",
}
# the JAX CLI's multi-process flags
MULTI_PROCESS_FLAGS = ("coordinator_address", "num_processes", "process_id")


def _commands():
    from vargp_tpu_torch.experiments import analysis, vargp_run

    return {
        "toy": vargp_run.toy,
        "s_mnist": vargp_run.split_mnist,
        "p_mnist": vargp_run.permuted_mnist,
        "s_digits": vargp_run.split_digits,
        "varying_m": vargp_run.varying_m,
        "analyze_smnist": analysis.analyze_smnist,
        "analyze_pmnist": analysis.analyze_pmnist,
        "analyze_sdigits": analysis.analyze_sdigits,
        "analyze_toy": analysis.analyze_toy,
    }


def _parse_value(s: str):
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def _parse_args(argv):
    args, kwargs = [], {}
    for a in argv:
        if a.startswith("--"):
            k, sep, v = a[2:].partition("=")
            if sep and not v:
                # `--log_dir=` would parse to True and fail far downstream
                raise SystemExit(f"empty value for --{k} (use --{k}=VALUE)")
            kwargs[k.replace("-", "_")] = _parse_value(v) if sep else True
        else:
            args.append(_parse_value(a))
    return args, kwargs


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cmds = _commands()
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("usage: python -m vargp_tpu_torch <command> [--key=value ...]\n")
        for name, fn in cmds.items():
            print(f"  {name}{inspect.signature(fn)}")
        print("\n--device=cpu|cuda picks the device (default cuda: the card).")
        print("not ported yet: " + ", ".join(f"{k} ({v})" for k, v in NOT_PORTED.items()))
        return 0
    name = argv[0]
    if name in NOT_PORTED:
        print(f"{name!r} is not ported to vargp_tpu_torch yet: ROADMAP {NOT_PORTED[name]}",
              file=sys.stderr)
        return 2
    if name not in cmds:
        print(f"unknown command {name!r}; run with --help", file=sys.stderr)
        return 1
    args, kwargs = _parse_args(argv[1:])
    if "platform" in kwargs:
        raise SystemExit("--platform is the JAX CLI's; use --device=cpu|cuda")
    if any(k in kwargs for k in MULTI_PROCESS_FLAGS):
        from vargp_tpu_torch.train.loop import _MULTI_DEVICE

        raise NotImplementedError(_MULTI_DEVICE)
    if kwargs.get("device", "cuda") not in ("cpu", "cuda"):
        raise SystemExit(f"--device={kwargs['device']!r}: expected cpu or cuda")
    cmds[name](*args, **kwargs)
    return 0
