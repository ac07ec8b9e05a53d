# The paper's filter pipeline (CF/CCF/CLF branch heads, CAM localisation,
# the shared staged query plan, cascade execution, streaming windows) and
# its aggregate half (control variates, accuracy contracts).
from repro_torch.core import (aggregates, cam, cascade, contracts, costmodel,
                              filters, plan, query, stats, stepcache,
                              streaming)

__all__ = ["aggregates", "cam", "cascade", "contracts", "costmodel",
           "filters", "plan", "query", "stats", "stepcache", "streaming"]
