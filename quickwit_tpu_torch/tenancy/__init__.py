"""Multi-tenant workload isolation.

Tenant identity (`context`), weighted deficit-round-robin admission
scheduling (`drr`), token-bucket quotas + accounting (`registry`) and
adaptive lowest-priority-first overload shedding (`overload`). See
docs/multi-tenancy.md for the end-to-end contract.
"""

from .context import (  # noqa: F401
    DEFAULT_CLASS, DEFAULT_TENANT, ES_FALLBACK_HEADER, MAX_PRIORITY,
    PRIORITY_CLASSES, TENANT_HEADER, TenantContext, bind_tenant,
    current_tenant, effective_tenant, tenant_scope,
)
from .drr import DrrScheduler, DrrTicket  # noqa: F401
from .overload import OVERLOAD, OverloadController, OverloadShed  # noqa: F401
from .registry import (  # noqa: F401
    GLOBAL_TENANCY, MAX_TENANT_LABELS, OVERFLOW_LABEL, TenancyRegistry,
    TenantRateLimited, configure_tenancy,
)
