"""The sharded solver over ``torch.distributed`` (paper §3.3): plans and
collectives (``spmv``, ``collectives``) and the halo/psum IRLS driver
(``solver.ShardedSolver``, the session's ``backend="sharded"``)."""
