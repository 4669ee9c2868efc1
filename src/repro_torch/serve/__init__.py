from repro_torch.serve.controller import (ServeController, ServeRecovery,
                                          ServeReport, plan_serve_batch)
from repro_torch.serve.engine import (BatchScheduler, Request, ServeCfg,
                                      generate, make_decode_step)
from repro_torch.serve.paging import (OutOfPages, PagePool, PageTable,
                                      RequestCache, resolve_page_tokens)
from repro_torch.serve.state import (SchedulerSnapshot, SlotSnapshot,
                                     load_snapshot, save_snapshot)

__all__ = ["BatchScheduler", "OutOfPages", "PagePool", "PageTable",
           "Request", "RequestCache", "SchedulerSnapshot", "ServeCfg",
           "ServeController", "ServeRecovery", "ServeReport",
           "SlotSnapshot", "generate", "load_snapshot", "make_decode_step",
           "plan_serve_batch", "resolve_page_tokens", "save_snapshot"]
