"""Seconds of ``Problem.build`` and the plans the session uploads (the ELL
and block plans, the device graph), on the harness's clock in set-up."""


def read(run):
    return run.record.get("problem_build_s")
