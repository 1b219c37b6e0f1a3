"""tokens_per_round (tokens): output tokens over engine rounds, over
every wave of the window: how many lanes a round carries, as the
scheduler and the KV pool allow."""


def read(r):
    rounds = sum(s.rounds for s in r.stats)
    if not rounds:
        return None
    return sum(s.tokens_out for s in r.stats) / rounds
