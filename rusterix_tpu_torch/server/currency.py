"""Multi-denomination currency system (reference src/server/currency.rs):
Currency definitions with exchange rates and per-denomination balance caps,
a Currencies registry with base-currency conversion, and the overflow-aware
Wallet operations (adding past a denomination's max_limit carries into the
next higher denomination; spending drains high-value denominations first)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class Currency:
    """currency.rs:4-9."""

    name: str
    symbol: str
    exchange_rate: float  # value of 1 unit in base-currency units
    max_limit: Optional[int] = None


@dataclass
class Currencies:
    """Registry of denominations keyed by symbol (currency.rs:16-55)."""

    currencies: Dict[str, Currency] = field(default_factory=dict)
    base_currency: str = ""

    def add_currency(self, currency: Currency) -> None:
        if currency.symbol in self.currencies:
            raise ValueError(f"Currency {currency.symbol} already exists.")
        self.currencies[currency.symbol] = currency

    def get_currency(self, symbol: str) -> Optional[Currency]:
        return self.currencies.get(symbol)

    def convert_from_base(self, base_amount: int, to_symbol: str) -> int:
        c = self.get_currency(to_symbol)
        if c is None:
            raise KeyError(f"Currency {to_symbol} not found.")
        return _round_half_away(base_amount / c.exchange_rate)

    def convert_to_base(self, amount: int, from_symbol: str) -> int:
        c = self.get_currency(from_symbol)
        if c is None:
            raise KeyError(f"Currency {from_symbol} not found.")
        return _round_half_away(amount * c.exchange_rate)


def _round_half_away(x: float) -> int:
    """Rust f32::round semantics (half away from zero) — Python's round()
    is banker's rounding and diverges on exact .5 amounts
    (currency.rs uses .round() throughout)."""
    import math

    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


class CurrencyError(Exception):
    pass


def wallet_add(wallet, symbol: str, amount: int, currencies: Currencies) -> None:
    """Add `amount` of `symbol`, overflowing past max_limit into the next
    higher-valued denomination (currency.rs:76-127)."""
    if amount < 0:
        raise CurrencyError("Cannot add a negative amount.")
    remaining = amount
    current = symbol
    while remaining > 0:
        c = currencies.get_currency(current)
        if c is None:
            raise CurrencyError(f"Currency {current} does not exist.")
        balance = wallet.balances.get(current, 0)
        cap = c.max_limit if c.max_limit is not None else float("inf")
        addable = cap - balance
        if addable >= remaining:
            wallet.balances[current] = balance + remaining
            remaining = 0
        else:
            wallet.balances[current] = balance + int(addable)
            remaining -= int(addable)
            # NOTE: the reference body (currency.rs:100-118) filters for
            # rates BELOW the current denomination and re-assigns the
            # base-unit amount without converting into the next currency —
            # internally inconsistent with its own convert_to_base and
            # evidently untested. Implement the documented intent: carry
            # into the cheapest denomination MORE valuable than this one.
            base_amount = currencies.convert_to_base(remaining, current)
            higher = [
                cc for cc in currencies.currencies.values()
                if cc.exchange_rate > c.exchange_rate
            ]
            if not higher:
                raise CurrencyError("No higher currency available for overflow.")
            nxt = min(higher, key=lambda cc: cc.exchange_rate)
            current = nxt.symbol
            remaining = currencies.convert_from_base(base_amount, current)


def wallet_add_base(wallet, base_amount: int, currencies: Currencies) -> None:
    """currency.rs:59-74."""
    if base_amount < 0:
        raise CurrencyError("Cannot add a negative amount.")
    wallet_add(wallet, currencies.base_currency, base_amount, currencies)


def wallet_spend(wallet, base_amount: int, currencies: Currencies) -> None:
    """Spend `base_amount` (base units) draining high-value denominations
    first (currency.rs:129-157); raises when insufficient."""
    remaining = base_amount
    for c in sorted(
        currencies.currencies.values(), key=lambda cc: -cc.exchange_rate
    ):
        bal = wallet.balances.get(c.symbol)
        if bal is None:
            continue
        available_base = currencies.convert_to_base(bal, c.symbol)
        to_spend_base = min(remaining, available_base)
        to_spend = currencies.convert_from_base(to_spend_base, c.symbol)
        wallet.balances[c.symbol] = bal - to_spend
        remaining -= to_spend_base
        if remaining <= 0:
            break
    if remaining > 0:
        raise CurrencyError("Insufficient funds.")


def wallet_balance(wallet, currencies: Currencies) -> int:
    """Total wallet value in base units (currency.rs:160-169)."""
    total = 0
    for symbol, amount in wallet.balances.items():
        c = currencies.get_currency(symbol)
        if c is not None:
            total += _round_half_away(amount * c.exchange_rate)
    return total


def wallet_can_afford(wallet, base_amount: int, currencies: Currencies) -> bool:
    """currency.rs:171-174."""
    return wallet_balance(wallet, currencies) >= base_amount
