"""The continual-learning runtime (ports part of `repro.runtime`):
scheduler, cost model, ledger, inference server, train steps and the
fine-tuning executor. The composition root (`device`, `fleet`,
`continual`, `config`) is not ported yet."""
