"""first_predict_s: from the model and the training data in host memory,
a fresh server's construction and its first request's mean and variance
on the host (the mean over the traffic's repetitions)."""


def read(run):
    first = run.first_predict
    return sum(t for _, t in first) / len(first) if first else None
