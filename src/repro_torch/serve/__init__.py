from repro_torch.serve.engine import (BatchScheduler, Request, ServeCfg,
                                      generate, make_decode_step)
from repro_torch.serve.paging import (OutOfPages, PagePool, PageTable,
                                      RequestCache, resolve_page_tokens)
from repro_torch.serve.state import SchedulerSnapshot, SlotSnapshot

__all__ = ["BatchScheduler", "OutOfPages", "PagePool", "PageTable",
           "Request", "RequestCache", "ServeCfg", "SchedulerSnapshot",
           "SlotSnapshot", "generate", "make_decode_step",
           "resolve_page_tokens"]
