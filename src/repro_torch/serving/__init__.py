from .adapters import AdapterRegistry
from .engine import AdmissionError, Request, ServingEngine, bucket_len
from .paging import NULL_PAGE, alloc_pages, free_pages, init_pager

__all__ = ["AdapterRegistry", "AdmissionError", "Request", "ServingEngine", "bucket_len",
           "NULL_PAGE", "alloc_pages", "free_pages", "init_pager"]
