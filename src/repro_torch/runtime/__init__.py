"""The serving half of the continual-learning runtime (ports part of
`repro.runtime`): scheduler, cost model, ledger and inference server."""
