"""Device layer (``idle_share.<cells>``): the share of the traced window in
which no operation ran on the card."""
from perfbench.lib.readers import idle_share


def read(record: dict):
    return idle_share(record)
