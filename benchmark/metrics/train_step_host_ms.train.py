"""Host milliseconds of one ``train_step`` call, until it returns (the
median over the untraced window): what the host pays to enqueue an
update, which the card's work hides while it is shorter."""

import statistics


def read(obs):
    host = obs.get("window", {}).get("host_s")
    return statistics.median(host) * 1e3 if host else None
