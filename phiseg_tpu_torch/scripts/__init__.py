"""The results tools: ports of the repository's `scripts/` that turn eval
artifacts into the tables of RESULTS.md, profile the step and the sampler,
and report the synthetic tasks' annotator diversity. Each has a `main(argv)`
and runs as `python -m phiseg_tpu_torch <name>` (see `__main__.py`)."""
