"""WKV6 recurrence (ports `repro.kernels.rwkv`)."""
