"""Requests per batch over the batch size: the scheduler's finished tasks
over its batches over ``batch_size``, counter deltas across the window."""


def read(run):
    b, a = run.before.get("manager"), run.after.get("manager")
    if not a:
        return None
    done = (a["completed"] + a["failed"]) - (b["completed"] + b["failed"])
    batches = a["batches"] - b["batches"]
    if batches <= 0:
        return None
    return 100.0 * done / batches / run.deployment["batch_size"]
