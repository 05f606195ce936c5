"""Command-line interface; counterpart of ``vargp_tpu/experiments/cli.py``.

    python -m vargp_tpu_torch <command> [--key=value ...]

Values parse as Python literals; each command is a driver function and
its keywords.  ``--device=cpu|cuda`` picks the device (default: the
card, and no card is an error: nothing moves to the CPU unasked).  Every
command of the JAX package's CLI is here.

Multi-GPU: ``--n_devices=N [--model_parallel=K]`` runs a VAR-GP driver on
a mesh of N ranks (N / K data x K model).  Alone, the driver starts N
local ranks, rank r on card r.  With ``--coordinator_address=HOST:PORT
--num_processes=P --process_id=I`` every process of a P-process job runs
the same command with its own index: ``parallel.distributed.initialize``
joins them (process I on card ``LOCAL_RANK``, else I, modulo the visible
cards), and ``--n_devices=P`` builds the mesh over the job.
"""

import ast
import inspect
import sys

# the JAX CLI's multi-process flags
MULTI_PROCESS_FLAGS = ("coordinator_address", "num_processes", "process_id")


def _commands():
    from vargp_tpu_torch.experiments import (
        analysis,
        global_run,
        regression,
        retrain_run,
        sweep,
        vargp_run,
    )

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
        "toy_global": global_run.toy_global,
        "s_mnist_global": global_run.split_mnist,
        "p_mnist_global": global_run.permuted_mnist,
        "analyze_toy_global": analysis.analyze_toy_global,
        "analyze_smnist_global": analysis.analyze_smnist_global,
        "toy_retrain": retrain_run.toy,
        "regression": regression.regression,
        "compare_methods": analysis.compare_methods,
        "compare_vcl": analysis.compare_vcl,
        "gen_sweep": sweep.generate_vargp_sweep,
        "run_sweep": sweep.run_sweep,
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
        print("\n--device=cpu|cuda picks the device (default cuda: the card).\n"
              "--n_devices=N [--model_parallel=K]: a VAR-GP driver on a mesh of N ranks "
              "(N/K data x K model), started here on cards 0..N-1 (or the CPU);\n"
              "--coordinator_address=HOST:PORT --num_processes=P --process_id=I: join a "
              "P-process torch.distributed job (each process runs the same command with its "
              "own I); --n_devices=P then spans the job.")
        return 0
    name = argv[0]
    if name not in cmds:
        print(f"unknown command {name!r}; run with --help", file=sys.stderr)
        return 1
    args, kwargs = _parse_args(argv[1:])
    if "platform" in kwargs:
        raise SystemExit("--platform is the JAX CLI's; use --device=cpu|cuda")
    if kwargs.get("device", "cuda") not in ("cpu", "cuda"):
        raise SystemExit(f"--device={kwargs['device']!r}: expected cpu or cuda")
    # a multi-process job: every process runs the same command with its own
    # --process_id; the drivers' --n_devices then spans the job's ranks
    flags = {k: kwargs.pop(k) for k in MULTI_PROCESS_FLAGS if k in kwargs}
    if flags:
        from vargp_tpu_torch.parallel.distributed import initialize

        initialize(**flags, device=kwargs.get("device"))
    cmds[name](*args, **kwargs)
    return 0
