"""Extract the CABAC context-model initialization values (ISO/IEC 23094-1
spec constants) from the reference tables into a generated Python module.

Values are numeric spec constants (xevem_tbl.c:112-417, the xevem_init_*
arrays used when sps_cm_init_flag==1); each table has two rows
(intra-slice inits, inter-slice inits).  Run:

    python tools/gen_ctx_init.py xeve/src_main/xevem_tbl.c \
        xeve_jax/entropy/ctx_init.py
"""
import re
import sys


def extract(src_path):
    text = open(src_path).read()
    tables = {}
    for m in re.finditer(
            r"const s16 (xevem_init_\w+)\[2\]\[[^\]]+\]\s*=\s*\{(.*?)\};",
            text, re.S):
        name = m.group(1).replace("xevem_init_", "")
        body = m.group(2)
        rows = re.findall(r"\{([^{}]*)\}", body)
        assert len(rows) == 2, f"{name}: {len(rows)} rows"
        parsed = []
        for r in rows:
            vals = [int(v) for v in re.findall(r"-?\d+", r)]
            parsed.append(vals)
        assert len(parsed[0]) == len(parsed[1]), name
        tables[name] = parsed
    return tables


def main(src, dst):
    tables = extract(src)
    with open(dst, "w") as f:
        f.write('"""CABAC context initialization values (sps_cm_init_flag'
                ' == 1).\n\nAuto-generated by tools/gen_ctx_init.py from the'
                ' spec-constant tables\n(ISO/IEC 23094-1; reference'
                ' xevem_tbl.c:112-417).  Row 0: I-slice,\nrow 1: P/B-slice.'
                '  Do not edit by hand.\n"""\n\n')
        f.write("CTX_INIT = {\n")
        for name, rows in sorted(tables.items()):
            f.write(f"    {name!r}: (\n")
            for r in rows:
                f.write(f"        {tuple(r)!r},\n")
            f.write("    ),\n")
        f.write("}\n")
    print(f"wrote {dst}: {len(tables)} tables")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
