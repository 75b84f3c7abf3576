"""The paper's harness on the port (counterpart of the reference's
`benchmarks/` tables and workloads harness): `common.run_method` runs one
method on one continual benchmark and returns a paper-style row,
`run` builds Tables II-VIII and Figs. 13-14 from such rows, `workloads`
sweeps the workload presets into a BENCH document, and `trace_report`
summarizes a session's trace. Results go to `results_torch/` at the repo
root. Every entry point runs on the card unless the caller passes the
CPU (`repro_torch.resolve_device`)."""
