"""``python -m vargp_tpu_torch <command> [--key=value ...]``."""

if __name__ == "__main__":
    from vargp_tpu_torch.experiments.cli import main

    raise SystemExit(main())
