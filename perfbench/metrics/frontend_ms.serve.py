"""Host ms of the text frontend (normalizers and G2P) per request: the
pipeline's ``frontend`` timer's total across the window over the window's
requests."""


def read(run):
    spent = run.after["frontend_s"] - run.before["frontend_s"]
    if spent <= 0 or not run.records:
        return None
    return 1e3 * spent / len(run.records)
