from .ops import quadconv_contract
from .ref import quadconv_contract_ref

__all__ = ["quadconv_contract", "quadconv_contract_ref"]
