"""One module a kind of cell (``workloads/<cell>.json`` names it): each
has ``run(ctx) -> Outcome``."""
