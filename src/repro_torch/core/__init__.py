"""The policy simulator: policy math, workloads, engines and the front door
(:mod:`repro_torch.core.experiment`)."""
