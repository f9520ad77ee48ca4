from .engine import AdmissionError, Request, ServingEngine
from .paging import NULL_PAGE, alloc_pages, free_pages, init_pager

__all__ = ["AdmissionError", "Request", "ServingEngine", "NULL_PAGE",
           "alloc_pages", "free_pages", "init_pager"]
