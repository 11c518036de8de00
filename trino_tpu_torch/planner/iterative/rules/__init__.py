"""Rule library of the iterative optimizer (the port of the reference
``planner/iterative/rules/``; each module groups the miniatures of the
correspondingly-named Trino rules under sql/planner/iterative/rule/)."""
