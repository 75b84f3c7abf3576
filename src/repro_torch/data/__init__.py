from repro_torch.data import arrivals, streams

__all__ = ["arrivals", "streams"]
