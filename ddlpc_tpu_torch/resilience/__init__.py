"""Resilience: the exit-status and breadcrumb protocol of a training
process (``protocol``), fault injection (``chaos``) and the training
supervisor that relaunches a crashed, stalled or preempted run and
resumes it (``supervisor``; ``python -m
ddlpc_tpu_torch.resilience.supervisor``).  Stdlib only: the supervisor
outlives what it babysits."""
