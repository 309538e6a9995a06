from . import ast
from .lexer import LexError, Token, tokenize
from .parser import ParseError, Parser, parse

__all__ = ["ast", "LexError", "Token", "tokenize", "ParseError", "Parser", "parse"]
