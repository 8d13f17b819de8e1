"""raylint checkers.

Each checker module exports:
- ``RULE``: the rule id (kebab-case, used in suppressions + baseline)
- ``EXPLAIN``: rationale shown by ``--explain <rule>``
- ``check_project(project) -> List[Violation]``
"""
