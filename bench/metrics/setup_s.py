"""setup_s: from the start of the process to the first timed round:
imports, the card's start-up, weights and traffic, the kernels' build
(first run in a checkout), round 0 and the rounds the comparison reads
(host clock)."""


def read(run):
    return run.setup_s
