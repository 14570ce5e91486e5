"""Minimal dependency-free .xlsx writer (port of ``mopa_tpu/common/xlsx.py``).

The reference exports class-IoU tables as .xlsx via openpyxl
(``mopa/common/utils/metric_logger.py:119-135``); the port does not depend
on openpyxl: the xlsx container is just a zip of five small XML parts, so
this module writes a spec-compliant single-sheet workbook directly (numbers
as native numeric cells, everything else as inline strings: readable by
Excel, LibreOffice, pandas and openpyxl alike).
"""

import zipfile
from xml.sax.saxutils import escape

_CONTENT_TYPES = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
    '<Default Extension="rels" ContentType='
    '"application/vnd.openxmlformats-package.relationships+xml"/>'
    '<Default Extension="xml" ContentType="application/xml"/>'
    '<Override PartName="/xl/workbook.xml" ContentType='
    '"application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
    '<Override PartName="/xl/worksheets/sheet1.xml" ContentType='
    '"application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
    "</Types>"
)

_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
    'officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
    "</Relationships>"
)

_WORKBOOK = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
    'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
    '<sheets><sheet name="{name}" sheetId="1" r:id="rId1"/></sheets></workbook>'
)

_WORKBOOK_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
    'officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>'
    "</Relationships>"
)


def _col_name(idx):
    """0-based column index -> A1-style column letters."""
    name = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(ord("A") + rem) + name
    return name


def _cell_xml(ref, value):
    if isinstance(value, bool):
        return '<c r="{}" t="b"><v>{}</v></c>'.format(ref, int(value))
    if isinstance(value, (int, float)):
        if value != value or value in (float("inf"), float("-inf")):
            value = str(value)  # NaN/inf: not representable as numeric cells
        else:
            return '<c r="{}"><v>{}</v></c>'.format(ref, repr(value))
    return '<c r="{}" t="inlineStr"><is><t>{}</t></is></c>'.format(
        ref, escape(str(value)))


def write_xlsx(path, rows, sheet_name="Sheet1"):
    """Write ``rows`` (iterable of iterables of str/int/float/bool cells) as a
    single-sheet .xlsx workbook at ``path``."""
    body = []
    for r, row in enumerate(rows, start=1):
        cells = "".join(_cell_xml("{}{}".format(_col_name(c), r), v)
                        for c, v in enumerate(row))
        body.append('<row r="{}">{}</row>'.format(r, cells))
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main"><sheetData>{}</sheetData></worksheet>'
    ).format("".join(body))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml",
                   _WORKBOOK.format(name=escape(sheet_name[:31])))
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
    return path


def read_xlsx_rows(path):
    """Read back the first sheet of a (simple) xlsx as a list of row lists;
    handles numeric, boolean and inline-string cells."""
    import re

    with zipfile.ZipFile(path) as z:
        xml = z.read("xl/worksheets/sheet1.xml").decode("utf-8")
    rows = []
    for row_m in re.finditer(r"<row[^>]*>(.*?)</row>", xml, re.S):
        cells = []
        for cell_m in re.finditer(r"<c([^>]*)>(.*?)</c>", row_m.group(1), re.S):
            attrs, inner = cell_m.group(1), cell_m.group(2)
            t_m = re.search(r't="(\w+)"', attrs)
            t = t_m.group(1) if t_m else None
            if t == "inlineStr":
                from xml.sax.saxutils import unescape

                m = re.search(r"<t>(.*?)</t>", inner, re.S)
                cells.append(unescape(m.group(1)) if m else "")
            else:
                m = re.search(r"<v>(.*?)</v>", inner, re.S)
                val = m.group(1) if m else ""
                if t == "b":
                    cells.append(bool(int(val)))
                else:
                    try:
                        cells.append(float(val))
                    except ValueError:
                        cells.append(val)
        rows.append(cells)
    return rows
