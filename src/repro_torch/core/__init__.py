# The paper's filter pipeline: CF/CCF/CLF branch heads, CAM localisation,
# the shared staged query plan, cascade execution and streaming windows.
from repro_torch.core import (cam, cascade, costmodel, filters, plan, query,
                              stats, stepcache, streaming)

__all__ = ["cam", "cascade", "costmodel", "filters", "plan", "query",
           "stats", "stepcache", "streaming"]
