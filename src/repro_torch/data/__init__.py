"""repro_torch.data — the synthetic LM, recsys and graph batch streams
(a copy of ``repro.data``)."""
