"""serve_setup_ms: the fresh server's construction inside
first_predict_s, ended by a synchronize (the mean over repetitions)."""


def read(run):
    first = run.first_predict
    return sum(s for s, _ in first) / len(first) * 1e3 if first else None
