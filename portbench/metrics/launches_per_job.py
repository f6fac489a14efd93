"""launches_per_job: the program's kernel launches in the window
(kernels.LAUNCHES, summed over its kernels), per job."""


def read(run):
    if not run.jobs or run.launches is None:
        return None
    return sum(run.launches.values()) / len(run.jobs)
