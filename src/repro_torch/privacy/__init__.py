"""``repro_torch.privacy`` — the pluggable privacy-accountant registry
(``repro.privacy`` counterpart).

>>> from repro_torch import privacy
>>> privacy.registered()
('advanced', 'basic', 'rdp', 'subexp')
>>> privacy.multiplier_ratio("rdp", 5.0, 1e-5, 6)   # sigma vs basic
0.377...

See ``repro_torch.privacy.registry`` for the Accountant contract and
``repro_torch.privacy.accountants`` for the four entries.
"""
from repro_torch.privacy.registry import (Accountant, get_accountant,
                                          multiplier_ratio, register,
                                          registered, resolve)
from repro_torch.privacy import accountants as _accountants  # noqa: F401

__all__ = ["Accountant", "get_accountant", "multiplier_ratio", "register",
           "registered", "resolve"]
