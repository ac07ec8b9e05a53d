# The paper's filter pipeline (CF/CCF/CLF branch heads, CAM localisation,
# the shared staged query plan, cascade execution, streaming windows) and
# its aggregate half (control variates, accuracy contracts), and the
# temporal tier (streaming automata over frame verdicts).
from repro_torch.core import (aggregates, cam, cascade, contracts, costmodel,
                              filters, plan, query, stats, stepcache,
                              streaming, temporal)

__all__ = ["aggregates", "cam", "cascade", "contracts", "costmodel",
           "filters", "plan", "query", "stats", "stepcache", "streaming",
           "temporal"]
